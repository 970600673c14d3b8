"""The readers of the program's spans and stage samples on a planted
``trace.Span``: two frames of the ICP step with known span times, and a
trace without the program's spans (its readers give nothing)."""
from __future__ import annotations

import pytest

from benchmark import harness, trace

# (name, start us, end us) of two frames; each voxel pass syncs once
FRAME = [("pcs.prepare", 0, 1000), ("aten::mul", 100, 200),
         ("pcs.icp", 1000, 6000), ("pcs.sync", 1500, 1700),
         ("pcs.icp.iter", 2000, 3000), ("pcs.icp.iter", 3000, 4000),
         ("pcs.output", 6000, 9000), ("pcs.output.voxel", 7000, 9000),
         ("pcs.sync", 7500, 8000)]


def _span(frames=2, ops=FRAME, stages=None):
    cpu = [(n, a + 10000 * f, b + 10000 * f)
           for f in range(frames) for n, a, b in ops]
    return trace.Span(frames=frames, cpu_ops=cpu,
                      device_ops=[("k", 0.0, 5.0)], stages=stages or {})


@pytest.mark.parametrize("metric,want", [
    ("stitcher.prepare_host_ms", 1.0),
    ("stitcher.icp_host_ms", 4.8),        # 5 ms less its 0.2 ms sync
    ("stitcher.output_host_ms", 2.5),     # 3 ms less its 0.5 ms sync
    ("stitcher.sync_wait_ms", 0.7),
    ("stitcher.host_syncs", 2.0),
])
def test_stage_readers_take_self_time_less_the_syncs(metric, want):
    assert harness.reader(metric)(_span()) == pytest.approx(want)


def test_stage_readers_sum_to_the_frames_spans():
    span = _span()
    got = sum(harness.reader(m)(span) for m in (
        "stitcher.prepare_host_ms", "stitcher.icp_host_ms",
        "stitcher.output_host_ms", "stitcher.sync_wait_ms"))
    assert got == pytest.approx(9.0)   # the frame's three stages, 9 ms


@pytest.mark.parametrize("metric", [
    "stitcher.prepare_host_ms", "stitcher.icp_host_ms",
    "stitcher.output_host_ms", "stitcher.sync_wait_ms",
    "stitcher.host_syncs", "client.held_ms", "client.frame_age_ms"])
def test_a_trace_without_the_programs_spans_reads_nothing(metric):
    span = _span(ops=[("aten::mul", 0, 100)])
    assert harness.reader(metric)(span) is None


@pytest.mark.parametrize("metric,stage", [("client.held_ms", "held"),
                                          ("client.frame_age_ms",
                                           "frame_age")])
def test_client_readers_take_the_mean_stage_sample(metric, stage):
    span = _span(stages={stage: [0.010, 0.030], "dispatch": [1.0]})
    assert harness.reader(metric)(span) == pytest.approx(20.0)
