"""stitcher.sync_wait_ms: host ms a traced frame spent in the step's
blocking device-to-host reads (``pcs.sync`` spans: each voxel pass's
branch choice), waiting for the device to catch up."""
from benchmark import spans


def read(span):
    return spans.sync_ms(span)
