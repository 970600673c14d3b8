"""stitcher.device_ops: device operations (kernels, copies, fills) per
stitched frame in the traced span."""


def read(span):
    return len(span.device_ops) / span.frames if span.device_ops else None
