"""client.latency_p95_ms: the 95th percentile, in ms, of the served
stream's latency (a frame's delivery to ``on_frame`` after its sync less
the capture time of the newest camera frame it holds) over the window's
frames outside the traced span. The tail of the same latency whose median
is ``latency_p50_ms``; it follows the host's slow seconds, so it is read
here, without a bound."""
import numpy as np


def read(span):
    v = span.latencies
    return float(np.percentile(v, 95)) * 1e3 if v else None
