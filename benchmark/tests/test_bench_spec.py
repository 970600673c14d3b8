"""BENCHMARK.json against its contract, and what the benchmark may load.

Every cell, configuration, traffic mix and per-layer metric resolves to
its file by name; names and units use the allowed characters; nothing the
benchmark imports is JAX or the JAX package, and its sources read none of
the repo's older bench scripts.
"""
from __future__ import annotations

import re
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_the_top_level_keys_are_the_contracts():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_each_configuration_has_its_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    body = harness.config(cfg["name"])
    assert body["name"] == cfg["name"]
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    assert cfg["source"].startswith("https://") and len(cfg["source"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_to_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    assert mix["kind"] in harness.RUNNERS
    e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell["name"],
                                                   "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.cell_metrics(SPEC, cell["name"], "per_layer")
    assert layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(metric["name"]))
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric["workloads"]) <= cells


def test_names_units_and_bounds_keep_to_the_contract():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            for k in ("config", "traffic"):
                if k in e:
                    assert NAME.match(e[k])
            for k in e.get("reduced", []):
                assert NAME.match(k)
    assert len(set(n for _, n in names if _ != "configs")) == \
        len([n for _, n in names if _ != "configs"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.run, benchmark.harness, benchmark.loop, "
        "benchmark.stream, benchmark.check, benchmark.control, "
        "benchmark.camera\n"
        "from benchmark import harness\n"
        "for m in harness.benchmark_spec()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "import pointcloud_stitching_tpu_torch\n"
        "from pointcloud_stitching_tpu_torch.native import snappy\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_sources_read_no_older_bench_runner():
    banned = re.compile(r"\b(bench_card|bench_torch|bench\.py|BENCH_"
                        r"|scripts/|tests\.oracle|import jax"
                        r"|pointcloud_stitching_tpu[ .]|"
                        r"pointcloud_stitching_tpu$)")
    for path in harness.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for line in path.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")) or \
                    "open(" in line:
                assert not banned.search(line), f"{path}: {line}"


def test_forbidden_names_are_compared_whole(monkeypatch):
    probe = type(sys)("probe")
    for name in ("pointcloud_stitching_tpu_torch.utils", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, probe)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pointcloud_stitching_tpu.ops", probe)
    monkeypatch.setitem(sys.modules, "jax.numpy", probe)
    assert harness.forbidden_modules() == ["jax",
                                           "pointcloud_stitching_tpu"]
