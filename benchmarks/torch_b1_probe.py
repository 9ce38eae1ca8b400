"""Kernel B1 shape by shape on an H100: time, bound, share of bound, bit-equality.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 benchmarks/torch_b1_probe.py [--shapes NAME ...]

For each shape ``(num_bands, words per band W, probes P, C, Q)`` below,
the script draws the inputs of ``chip_smoke.py``'s phase 2 (store words
from a 4-letter alphabet, planted full matches, ~10% dead slots, probe
t > 0 flipping bit t-1), checks
``lshrs_tpu_torch.ops.group_max.group_max_keys`` bit for bit against
``group_max_keys_ref`` at group 64, times the kernel (median of CUDA-event
times of single launches after a warm-up) and prints one JSON line: per
shape its ms, ``kernel_bound``'s ms (one integer compare per band word
per probe at the H100's int32 rate), the share of the bound, the
equality, and the card's name and power limit. Shapes:

- the bandings users get past the power-of-two ones: the auto-tuner's 48
  x 8, 24 x 8 and 12 x 16, the default 8 x 16 index with
  ``multiprobe=2``, 16 x 16 with ``multiprobe=3``, and 32 bands of two
  words, at C = 2**20, Q = 512;
- every shape ``chip_smoke.py`` times: the main shape (16 band words,
  C = 131,072, Q = 1,024) with 1, 2 and 4 probes, 32 band words with 1,
  2 and 4 probes there, the recall sweep's bandings (64 x 4, 32 x 8 with
  1 and 4 probes, 16 x 16, 8 x 32, 4 x 64) at C = 2**20, Q = 512, and the
  gather rerank's 256-query slices at C = 2**20;
- 16 x 16 with five probes (five threads of one probe each) and 16 bands
  of three words (the kernel's generic instantiation), at C = 2**20,
  Q = 512.

Numbers depend on the card: compare two versions within one run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lshrs_tpu_torch.ops import group_max as gm  # noqa: E402

C_1M, C_128K = 1 << 20, 1 << 17
GROUP = 64
REPS = 20  # timed launches a shape
SEED = 0
# name -> (num_bands, words, probes, C, Q)
SHAPES = {
    "48x8": (48, 1, 1, C_1M, 512),
    "24x8": (24, 1, 1, C_1M, 512),
    "12x16": (12, 1, 1, C_1M, 512),
    "8x16_probes2": (8, 1, 2, C_1M, 512),
    "16x16_probes3": (16, 1, 3, C_1M, 512),
    "32x2words": (32, 2, 1, C_1M, 512),
    "main_16": (16, 1, 1, C_128K, 1024),
    "main_16_probes2": (16, 1, 2, C_128K, 1024),
    "main_16_probes4": (16, 1, 4, C_128K, 1024),
    "main_32": (32, 1, 1, C_128K, 1024),
    "main_32_probes2": (32, 1, 2, C_128K, 1024),
    "main_32_probes4": (32, 1, 4, C_128K, 1024),
    "recall_64x4": (64, 1, 1, C_1M, 512),
    "recall_32x8": (32, 1, 1, C_1M, 512),
    "recall_32x8_probes4": (32, 1, 4, C_1M, 512),
    "recall_16x16": (16, 1, 1, C_1M, 512),
    "recall_8x32": (8, 1, 1, C_1M, 512),
    "recall_4x64": (4, 2, 1, C_1M, 512),
    "gather_16": (16, 1, 1, C_1M, 256),
    "gather_16_probes4": (16, 1, 4, C_1M, 256),
    "gather_32": (32, 1, 1, C_1M, 256),
    "16x16_probes5": (16, 1, 5, C_1M, 512),
    "16x3words": (16, 3, 1, C_1M, 512),
}


def probe(name: str, rng, dev) -> dict:
    nb, w, probes, c, q = SHAPES[name]
    sig_t, tie, qw = chip_smoke.b1_inputs(rng, bw=nb * w, c=c, q=q, probes=probes, dev=dev)
    kw = dict(num_bands=nb, words=w, group=GROUP, scale=gm.key_scale(c), probes=probes)
    got = gm.group_max_keys(sig_t, tie, qw, **kw)
    step = max(1, chip_smoke.B1_PLAIN_ELEMENTS // c)
    equal = all(torch.equal(got[s : s + step], gm.group_max_keys_ref(sig_t, tie, qw[s : s + step], **kw))
                for s in range(0, q, step))
    ms = chip_smoke.median_ms(lambda: gm.group_max_keys(sig_t, tie, qw, **kw), reps=REPS)
    bound_ms, bound_by = chip_smoke.kernel_bound(
        "group_max_keys", dict(C=c, Q=q, bands=nb * w, probes=probes))
    return {"shape": name, "num_bands": nb, "words": w, "probes": probes, "C": c, "Q": q,
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "equal": equal}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", nargs="+", choices=sorted(SHAPES), default=list(SHAPES))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_b1_probe: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = [probe(name, rng, dev) for name in args.shapes]
    print(json.dumps({"b1_probe": {"card": chip_smoke.card_label(), "group": GROUP,
                                   "shapes": rows}}))
    return 0 if all(row["equal"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
