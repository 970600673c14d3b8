"""Whole runs of each cell with the harness's look for a GPU skipped: on
the CPU at a small size, sound runs come out correct and each fault
planted under the timed path comes out not correct. On the card, at each
cell's own size: the planted faults come out not correct, and the control
(the reference computed at TF32 in the program's place) fails the limits
that the program passes."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import check, control, harness, reference
from benchmark.tests.planted import FAULTS, plant, shrink

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
MIX_OF = {w["name"]: w["traffic"] for w in SPEC["workloads"]}
SMALL = {c["name"]: shrink(harness.config(c["name"])) for c in SPEC["configs"]}


def _small(mix: dict) -> dict:
    """A mix cut to the CPU: short windows, 10 FPS cameras, 2 judged
    frames."""
    if mix["kind"] == "closed":
        return dict(mix, window_frames=3, sample_range=3, samples=2)
    return dict(mix, camera_fps=10, client_fps=10, warmup_frames=2,
                sample_range=8, samples=2)


MIXES = {m: _small(harness.traffic(m)) for m in set(MIX_OF.values())}
SECONDS = {"closed": 0.1, "stream": 2.0}
# (seconds, overrides) by cell: the ICP stitch takes about a second a
# frame on the CPU, so its stream runs longer, draws from fewer frames and
# waits longer before it calls a camera stale
SIZE = {cell: (8.0, {"sample_range": 3, "stale_timeout_s": 5.0})
        for cell in ("rig8_ring_icp.stream15", "rig4_ring_icp.stream30")}


def _run(monkeypatch, cell, fault=None, trace_on=False, seed=2 ** 32 + 17,
         seconds=None, **over):
    mix = MIX_OF[cell]
    own_s, own = SIZE.get(cell, (SECONDS[MIXES[mix]["kind"]], {}))
    plant(monkeypatch, SMALL, {mix: dict(MIXES[mix], **own, **over)}, fault)
    seconds = own_s if seconds is None else seconds
    return harness.run_cell(cell, seed, seconds, trace_on, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(monkeypatch, cell):
    line, lines = _run(monkeypatch, cell)
    assert line["correct"], lines
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(check.NAMES) | {"wrong_frames"}
    assert set(line["metrics"]) >= {"setup_s"}
    assert len(line["info"]["ref_voxels"]) >= 1


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, cell,
                                                     fault):
    line, lines = _run(monkeypatch, cell, fault)
    assert not line["correct"], lines
    assert line["attempted"] > 0


def test_a_traced_run_reports_its_per_layer_metrics(monkeypatch):
    line, _ = _run(monkeypatch, "rig8_fixed_cal.stream30", trace_on=True,
                   seconds=4.0, trace_frames=3)
    assert line["correct"]
    # all the cell's per-layer metrics but the device's idle share, which
    # a CPU trace has no device operation to read
    assert set(line["metrics"]) == {"client.dispatch_ms",
                                    "client.snapshot_ms",
                                    "client.latency_p95_ms",
                                    "client.held_ms",
                                    "client.frame_age_ms"}
    assert line["metrics"]["client.latency_p95_ms"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_traced_closed_run_counts_its_frames_work(monkeypatch):
    counted = []
    work = reference.work

    def spy(*args):
        counted.append(work(*args))
        return counted[-1]

    monkeypatch.setattr(reference, "work", spy)
    line, _ = _run(monkeypatch, "rig8_ring_icp.closed", trace_on=True,
                   seconds=0.2)
    assert line["correct"]
    # one count a traced frame, each within what the frames can hold
    assert len(counted) == MIXES["closed"]["window_frames"]
    st = SMALL["rig8_ring_icp"]["stitch"]
    for c in counted:
        assert 0 < c["voxels"] <= c["rows"] <= 8 * st["height"] * st["width"]
        assert all(0 < n <= st["icp_capacity"] for n in c["icp_points"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' own size, TF32")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_at_the_cells_own_size_is_not_correct(card, monkeypatch,
                                                      cell, fault):
    plant(monkeypatch, fault=fault)
    # long enough to stitch every frame the check may draw
    seconds = 12.0 if cell == "rig8_ring_icp.stream15" else (
        6.0 if MIX_OF[cell].startswith("stream") else 4.0)
    line, lines = harness.run_cell(cell, 4200000000 + CELLS.index(cell),
                                   seconds, False, card, time.perf_counter())
    print(cell, fault, line["checks"])
    assert not line["correct"], lines
    assert line["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_where_the_program_passes(card, name):
    cfg = dict(SMALL[name], limits=harness.config(name)["limits"])
    for seed in (1, 2, 3):
        ok, _ = check.verdict(control.readings(cfg, seed, 2, False, card),
                              cfg["limits"])
        assert ok
        bad, _ = check.verdict(control.readings(cfg, seed, 2, True, card),
                               cfg["limits"])
        assert not bad
