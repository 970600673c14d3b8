#!/usr/bin/env python3
"""Run one cell of the benchmark of pointcloud_stitching_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. It loads and
warms up (``setup_s``), measures for ``--seconds``, judges the window's
outputs against the plain reference, and prints as its last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit (also the last lines of
standard error). It exits non-zero without printing a result when there is
no GPU, when the cell asks for more GPUs than there are, when the port
cannot be imported, or when JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build caches live in the checkout at fixed paths (the
# port's own kernels and codec build into pointcloud_stitching_tpu_torch/
# _build/); these cover what torch itself could cache
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(var, str(ROOT / "benchmark" / ".cache" / sub))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch_s = time.perf_counter() - T_START
    from benchmark import harness
    spec = harness.benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    need = cells[args.workload]["chips"]
    if torch.cuda.device_count() < need:
        print(f"the cell needs {need} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import pointcloud_stitching_tpu_torch  # noqa: F401  (fails without it)
    import_s = time.perf_counter() - T_START
    from pointcloud_stitching_tpu_torch import native
    from pointcloud_stitching_tpu_torch.kernels import build as kb
    t = time.perf_counter()
    built = kb.build()
    native.load()
    build_s = time.perf_counter() - t

    # set-up leaves the build out: a first run in a checkout builds, the
    # others load the cached libraries (``info.build_s`` says how long)
    line, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0",
                                    T_START + build_s)
    found = harness.forbidden_modules()
    if found:
        print("the run loaded " + ", ".join(found), file=sys.stderr)
        return 4
    line["info"]["import_s"] = import_s
    line["info"]["torch_import_s"] = torch_s
    line["info"]["build_s"] = build_s
    line["info"]["kernels_cached"] = built.cached
    checks_last = line.pop("checks")
    line["checks"] = checks_last
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
