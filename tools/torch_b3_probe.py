"""Kernel B3 (packed Hamming on the int8 tensor cores) on one GPU: build,
registers, bit-exactness and times beside B2 and ``torch._int_mm``.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_b3_probe.py [--reps N] [--no-ptxas]

1. compiles ``lshrs_tpu_torch/csrc/hamming_{group_max,packed_group_max}.cu``
   once more with ``-Xptxas -v`` and prints each kernel instantiation's
   registers, spills and shared memory (skip with ``--no-ptxas``);
2. holds B3 bit-exact against its plain version at small shapes covering
   every expansion (word_bits 16, 8, 32, 3), the resident and the
   streamed slot tile, ragged Q and C;
3. times, in turns (each entry, then each again in reverse order) with
   CUDA events, B3 through its wrapper, B3's launch alone on a query
   operand built before, and the operand's build (``packed_operand``),
   B3 on the 16 x 16 store's words (word_bits 16, K = 256) against B2 on
   the same words' planes and ``torch._int_mm`` of the two +-1 operands,
   at Q = 512, C = 2**20 and (no library: the (Q, C) product is 128 GiB)
   at Q = 8192, C = 2**22; and B3 on random full words (K = 512) at
   Q = 512, C = 2**20. Each line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def ptxas_report() -> None:
    from lshrs_tpu_torch.ops import _build

    for name in ("hamming_group_max.cu", "hamming_packed_group_max.cu"):
        out = subprocess.run(
            [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
             str(_build._CSRC / name)],
            capture_output=True, text=True, timeout=600,
        )
        lines = [ln for ln in (out.stderr + out.stdout).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln
                 or "warning" in ln.lower() or "error" in ln.lower()]
        emit(phase="ptxas", source=name, rc=out.returncode, lines=lines)


def words(gen, *, bw, word_bits, c, q, dev):
    """Store-like words (word_bits random low bits) and stored-slot queries
    with ~10% of those bits flipped; ~10% dead slots."""
    from lshrs_tpu_torch.ops.scan import global_tie_core

    def draw(*shape):
        w = torch.randint(-(2**31), 2**31, shape, generator=gen, device=dev, dtype=torch.int64)
        return (w & ((1 << word_bits) - 1) if word_bits < 32 else w).to(torch.int32)

    sig_t = draw(bw, c)
    ids = torch.randperm(c, generator=gen, device=dev).to(torch.int32)
    ids[torch.rand(c, generator=gen, device=dev) < 0.1] = -1
    qw = draw(q, bw)
    pick = torch.randint(0, c, (q // 2,), generator=gen, device=dev)
    flip = (torch.rand((q // 2, bw, word_bits), generator=gen, device=dev) < 0.1).long()
    flips = (flip << torch.arange(word_bits, device=dev)).sum(-1) & 0xFFFFFFFF
    qw[: q // 2] = sig_t[:, pick].T ^ torch.where(flips >= 2**31, flips - 2**32, flips).to(torch.int32)
    return sig_t.contiguous(), global_tie_core(ids), qw.contiguous()


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b3_probe: no CUDA device", file=sys.stderr)
        return 1
    from lshrs_tpu_torch.ops import _build
    from lshrs_tpu_torch.ops import group_max as gm

    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.library()
    if not args.no_ptxas:
        ptxas_report()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    for bw, c, q, group, wb in [
        (16, 8192, 256, 64, 16), (32, 8192, 200, 64, 8), (16, 8192, 1, 16, 16),
        (16, 4096 + 64, 70, 32, 16), (12, 4096, 70, 128, 32), (10, 4096, 33, 16, 3),
        (32, 4096, 130, 64, 32), (64, 2048, 70, 32, 32), (16, 1 << 20, 512, 64, 16),
    ]:
        sig_t, tie, qw = words(gen, bw=bw, word_bits=wb, c=c, q=q, dev=dev)
        kw = dict(num_perm=bw * wb, group=group, scale=gm.key_scale(c), word_bits=wb)
        got = gm.hamming_packed_group_max_keys(sig_t, tie, qw, **kw)
        want = gm.hamming_packed_group_max_keys_ref(sig_t, tie, qw, **kw)
        torch.cuda.synchronize()
        emit(phase="check", BW=bw, C=c, Q=q, group=group, word_bits=wb,
             K=gm.packed_width(bw, wb), equal=bool(torch.equal(got, want)),
             max_abs_err=int((got.long() - want.long()).abs().max()))

    for c, q, wb in [(1 << 20, 512, 16), (1 << 22, 8192, 16), (1 << 20, 512, 32)]:
        bw = 16
        sig_t, tie, qw = words(gen, bw=bw, word_bits=wb, c=c, q=q, dev=dev)
        kw = dict(num_perm=bw * wb, group=64, scale=gm.key_scale(c), word_bits=wb)
        qop = gm.packed_operand(qw, word_bits=wb)
        sop = torch.cat([gm.packed_operand(sig_t[:, s : s + (1 << 20)].T, word_bits=wb)
                         for s in range(0, c, 1 << 20)])
        out = torch.empty((q, c // 64), dtype=torch.int32, device=dev)
        kp = gm.packed_width(bw, wb)

        def kernel_only():  # the launch alone, on a query operand built before
            gm._launch("lshrs_hamming_packed_group_max", dev, sig_t.data_ptr(), tie.data_ptr(),
                       qop.data_ptr(), out.data_ptr(), q, c, c, bw, wb, kp, 64, kw["scale"],
                       kw["num_perm"])

        runs = {"b3": lambda: gm.hamming_packed_group_max_keys(sig_t, tie, qw, **kw),
                "b3_kernel_only": kernel_only,
                "query_operand": lambda: gm.packed_operand(qw, word_bits=wb)}
        if wb * bw == 256:
            runs["b2_same_words"] = lambda: gm.hamming_group_max_keys(
                sop, tie, qop, group=64, scale=kw["scale"], num_perm=256)
        if q * c <= 1 << 29:
            runs["int_mm"] = lambda: torch._int_mm(qop, sop.t())
        order = list(runs) + list(runs)[::-1]
        ms = {name: [] for name in runs}
        for name in order:
            ms[name].append(event_ms(runs[name], args.reps))
        emit(phase="time", card=label, C=c, Q=q, BW=bw, word_bits=wb,
             K=gm.packed_width(bw, wb), ms=ms,
             bound_ms=2 * q * c * gm.packed_width(bw, wb) / 1.979e15 * 1e3)
        del sig_t, tie, qw, qop, sop, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
