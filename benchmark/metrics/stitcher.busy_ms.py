"""stitcher.busy_ms: summed device-operation time per stitched frame in
the traced span, in ms."""


def read(span):
    if not span.device_ops:
        return None
    return sum(b - a for _, a, b in span.device_ops) * 1e-3 / span.frames
