"""stitcher.host_syncs: the step's blocking device-to-host reads
(``pcs.sync`` spans) per traced frame: one per voxel pass."""
from benchmark import spans


def read(span):
    return spans.syncs(span)
