"""Where ``create_signatures``' build time goes beside ``index()`` on an H100.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_ingest_probe.py [--seed N]

Builds ``LSHRS(dim=768, num_perm=256, num_bands=16, rows_per_band=16)``
over the same 2**20 seeded gaussian vectors in 65,536-row batches, six
ways, each twice, in turns (forward then reverse order):

- ``index_arrays``: ``index()`` with NumPy id slices;
- ``index_lists``: ``index()`` with the Python ``list[int]`` ids the
  loaders yield (the reference's loader contract);
- ``create_signatures`` from ``format="numpy"`` with prefetch 0 and 2, on
  the serial loop (the CPU count forced to 1) and on the two-stage
  pipeline.

Each line carries the build's seconds and vectors/s. The first and last
builds of each way are checked for equal ``state_arrays()``. Numbers
depend on the card and on the host: compare within one run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lshrs_tpu_torch import LSHRS  # noqa: E402

N, DIM, BATCH = 1 << 20, 768, 1 << 16
DEVICE = "cuda"
WAYS = ("index_arrays", "index_lists", "serial_prefetch0", "serial_prefetch2",
        "pipeline_prefetch0", "pipeline_prefetch2")


def build(way: str, X: np.ndarray) -> tuple[float, LSHRS]:
    lsh = LSHRS(dim=DIM, num_perm=256, num_bands=16, rows_per_band=16, device=DEVICE)
    n = len(X)
    ids = np.arange(n)
    real_affinity = os.sched_getaffinity
    if way.startswith("serial"):
        os.sched_getaffinity = lambda pid: {0}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way.startswith("index"):
            for off in range(0, n, BATCH):
                batch_ids = ids[off : off + BATCH]
                lsh.index(batch_ids.tolist() if way == "index_lists" else batch_ids,
                          X[off : off + BATCH])
        else:
            lsh.create_signatures(format="numpy", vectors=X, batch_size=BATCH,
                                  prefetch=int(way[-1]))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, lsh
    finally:
        os.sched_getaffinity = real_affinity


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_ingest_probe: no CUDA device available", file=sys.stderr)
        return 1
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    X = np.random.default_rng(args.seed).standard_normal((N, DIM), dtype=np.float32)
    build("index_arrays", X[: 4 * BATCH])  # warm-up: cuBLAS, allocator
    seconds: dict[str, list[float]] = {}
    states: dict[str, dict] = {}
    for way in WAYS + WAYS[::-1]:
        s, lsh = build(way, X)
        seconds.setdefault(way, []).append(s)
        state = lsh._storage.state_arrays()
        if way in states:
            assert all(np.array_equal(state[k], states[way][k]) for k in state), way
        states[way] = state
        del lsh
        print(json.dumps({"way": way, "card": label, "rows": N, "batch": BATCH,
                          "cpus": len(os.sched_getaffinity(0)), "seconds": s,
                          "vectors_per_s": N / s}), flush=True)
    ref = states["index_arrays"]
    equal = all(all(np.array_equal(st[k], ref[k]) for k in ref) for st in states.values())
    print(json.dumps({"summary": {w: {"median_s": float(np.median(v)), "seconds": v}
                                  for w, v in seconds.items()},
                      "states_equal": equal, "card": label}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
