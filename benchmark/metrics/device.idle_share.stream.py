"""device.idle_share.stream: the share of the traced span of the served
stream in which no device operation ran, in % (``trace.idle_share_pct``,
the reader every idle share takes)."""
from benchmark.trace import idle_share_pct as read  # noqa: F401
