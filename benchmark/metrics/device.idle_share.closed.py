"""device.idle_share.closed: the share of the traced span of back-to-back
frames in which no device operation ran, in % (``trace.idle_share_pct``,
the reader every idle share takes)."""
from benchmark.trace import idle_share_pct as read  # noqa: F401
