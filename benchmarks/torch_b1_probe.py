"""Kernel B1's spilling register instantiation against the generic one on an H100.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 benchmarks/torch_b1_probe.py

``lshrs_tpu_torch/csrc/collision_group_max.cu`` keeps a query's
``probes * BW`` words in registers for a few template instantiations; any
other shape takes the generic instantiation, which re-reads the words
through L1 in the inner loop. ``<32, 1, 4>`` (32 band words, 4 probes)
holds 128 words per thread and spills 80 bytes. This script times it
against the generic instantiation on the same count of word compares
(16 bands of 2 words, 4 probes), in turns, at C = 131,072 and Q = 1,024,
each checked bit for bit against the plain version, and prints one JSON
line. It is the measurement behind keeping ``<32, 1, 4>`` in registers.
Numbers depend on the card: compare within one run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lshrs_tpu_torch.ops import group_max as gm  # noqa: E402
from lshrs_tpu_torch.ops.scan import global_tie_core  # noqa: E402

C, Q, PROBES, GROUP = 1 << 17, 1024, 4, 64
CASES = {"registers_32x1": (32, 1), "generic_16x2": (16, 2)}  # (num_bands, words)


def median_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b1_probe: no CUDA device available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    ids = rng.permutation(C).astype(np.int32)
    ids[rng.random(C) < 0.1] = -1
    tie = global_tie_core(torch.from_numpy(ids).cuda())
    sig = rng.integers(0, 4, (32, C), dtype=np.int32)
    q0 = rng.integers(0, 4, (Q, 32), dtype=np.int32)
    q0[: Q // 4] = sig[:, rng.integers(0, C, Q // 4)].T
    qw = np.concatenate([q0 ^ (np.int32(1) << t) if t else q0 for t in range(PROBES)], 1)
    sig_t, qw = torch.from_numpy(sig).cuda(), torch.from_numpy(np.ascontiguousarray(qw)).cuda()
    runs = {}
    for name, (nb, w) in CASES.items():
        kw = dict(num_bands=nb, words=w, group=GROUP, scale=gm.key_scale(C), probes=PROBES)
        if not torch.equal(gm.group_max_keys(sig_t, tie, qw, **kw),
                           gm.group_max_keys_ref(sig_t, tie, qw, **kw)):
            raise AssertionError(f"B1 kernel != plain at {name}")
        runs[name] = lambda kw=kw: gm.group_max_keys(sig_t, tie, qw, **kw)
    ms = {name: [] for name in CASES}
    for name in ("registers_32x1", "generic_16x2", "generic_16x2", "registers_32x1"):
        ms[name].append(median_ms(runs[name]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"b1_probe": {"card": card, "C": C, "Q": Q, "probes": PROBES,
                                   "word_compares": Q * C * 32 * PROBES, "ms": ms}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
