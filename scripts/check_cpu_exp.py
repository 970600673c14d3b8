#!/usr/bin/env python3
"""Look for a wrong first multithreaded ``torch.exp`` on the CPU.

Each of ``--procs`` fresh processes imports JAX and runs one jitted JAX
computation on the CPU (as the port's parity tests do first), then calls
``torch.exp`` on the CPU, multithreaded, on one fixed float32 input (the
Gaussian weights of ``ops/mls.py``'s radius sweep, values in [-60, 0]),
twice, and compares each result with float64 numpy. A process is a hit when
the first call's largest relative error exceeds ``--tol`` (a correct
float32 exp stays within a few 1e-7). Prints one line per process and the
hit rate; exits 1 if any process hit.

  JAX_PLATFORMS=cpu python scripts/check_cpu_exp.py --procs 40
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r"""
import numpy as np
import jax, jax.numpy as jnp
jax.jit(lambda a: jnp.exp(-a * a).sum())(jnp.arange(4096.0)).block_until_ready()
import torch
rng = np.random.default_rng(0)
x = torch.from_numpy(-rng.uniform(0.0, 60.0, (51, 4096)).astype(np.float32))
ref = np.exp(x.numpy().astype(np.float64))
errs = []
for _ in range(2):
    y = torch.exp(x).numpy().astype(np.float64)
    errs.append(float((np.abs(y - ref) / np.maximum(ref, 1e-30)).max()))
print(torch.get_num_threads(), errs[0], errs[1])
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=20)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS",
                                                        "cpu"))
    hits = 0
    for k in range(args.procs):
        out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                             capture_output=True, text=True, check=True)
        threads, first, second = out.stdout.split()[-3:]
        hit = float(first) > args.tol
        hits += hit
        print(f"process {k}: {threads} threads, first call rel. error "
              f"{float(first):.3e}, second {float(second):.3e}"
              f"{'  HIT' if hit else ''}", flush=True)
    print(f"hits: {hits} of {args.procs} processes")
    return 1 if hits else 0


if __name__ == "__main__":
    sys.exit(main())
