"""Smoke test of the PyTorch + CUDA port on one GPU: kernels, then the main path.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the hand-written kernels from ``lshrs_tpu_torch/csrc`` with nvcc
(at first use, into ``build/lshrs_tpu_torch/``, one compiler per source),
then runs these phases and prints JSON lines as it goes:

1. the card (nvidia-smi name and power limit) and the kernel build time;
2. each kernel (B1, B2, B3) against its plain PyTorch version on the card,
   bit-exact (``torch.equal``; tolerance 0: every output is an integer
   key), at the main path's shapes (B1 also at the gather rerank's
   C=2**20, Q=256; B2 also at the 1M serving batch, Q=8192, at P=512 with
   group 128, and at 30 bits padded to 32 columns), ragged query counts,
   dead slots and every template instantiation;
3. the 100k slice: ``LSHRS(dim=768, num_perm=256, num_bands=16,
   rows_per_band=16)`` indexes 100,000 seeded gaussian vectors and serves
   them through ``serving_fn(top_k=10)`` (collision engine, kernel B1):
   self-match must be 1.0, and the store carried to a ``device="cpu"``
   store must return the same ids for the same query words;
4. the 1M slice: the same constructor over 2**20 clustered vectors, where
   ``engine="auto"`` switches to Hamming ranking (kernel B2), with the
   same checks;
5. the packed_4m slice: ``hamming_storage="packed"`` over 2**22 clustered
   vectors (the largest capacity whose packed key fits int32 at 256
   bits), ranked by kernel B3 with no bitplanes allocated: self-match
   1.0, ids and distances equal to the bitplane path (kernel B2) and to
   the plain versions on the same store words; then 1% of the ids are
   deleted and none may come back;
6. times: each kernel against its plain version (median CUDA-event ms)
   and its bound (the least time the card could take: operations at their
   peak rate or bytes at the HBM rate, whichever is larger), B2 also
   against ``torch._int_mm`` on the same operands (the library yardstick,
   never called by the port),
   serving QPS at 100k, 1M and 4M (packed, and planes on the same
   words), a torch.profiler breakdown of the serving batches (device time
   by kernel, device-busy share), and the 100k build rate;
7. the lifecycle at 100k: ``save_to_disk`` then
   ``load_from_disk(device="cuda")`` returns the same ids, and
   ``delete`` then ``compact`` keeps self-match of the survivors at 1.0;
8. top-p cosine rerank (``store_vectors=True``). At 100k with a float32
   payload (``rerank_engine="auto"`` resolves to the full engine):
   self-match through ``serving_fn(mode="topp")`` (top-1 is the vector,
   its cosine within 1e-5 of 1), 256 queries against the store carried to
   the CPU (ids equal but for swaps of neighbours whose cosines differ by
   < 1e-5, cosines within 1e-5, candidate counts equal),
   ``get_above_p_batch`` equal to serving, ``get_above_p`` /
   ``query(top_k=None)`` one query at a time, and serving QPS of the full
   and the gather engine in turns. At 2**20 clustered vectors
   (the 1M slice's data) with an int8 payload: the full and the gather
   engine (kernel B1) on 1,024 queries — gather equal to full on every
   query it proves exact, both equal to the store carried to the CPU on
   256 of them (as at 100k), recall@10 of each against exact float32
   cosine at least 0.70 — then serving QPS of each engine at Q=1024 and 8192 in turns and a
   profile of one 8192-query batch each; last, at 100k, delete 1,000 ids
   and compact (no deleted id comes back) and save / load with the
   payload (the same top-p ids);
9. the hash families, multi-probe and ``where=`` filters (phase 2 also
   holds B1 bit-exact at ``probes`` 2 and 4 and at 32 band words, at
   131,072 slots and at the shapes the 2**20-slot paths launch: 256-query
   gather slices with 4 probes and with 32 band words, and the 8,192-query
   top-k batch at 32 band words):
   - hash parity on the card: structured (16 x 16) and cross-polytope
     (32 x 8) words of 65,536 x 768 vectors from ``hash_batch_words``
     (CUDA) == ``hash_batch_words_host`` (the native C FWHT, which must
     have loaded) == the NumPy FWHT; probe words host == device at T=4;
     hash times beside the gaussian matmul's;
   - structured_1m: ``LSHRS(hash_family="structured")`` over the 2**20
     clustered vectors with ``hash_mode="host"`` (planes and packed) and
     ``hash_mode="device"``: build rates, auto -> Hamming on B2 / B3,
     self-match 1.0, ids equal to a CPU copy on 256 queries, the three
     indexes equal to each other, serving QPS at Q=8192;
   - multi-probe: 100k gaussian vectors with ``multiprobe`` 2 and 4 (B1
     launched with that many probes, ids equal to a CPU copy, self-match
     1.0, every T=1 hit's count <= its count under T probes, QPS beside
     T=1), and the 1M int8 top-p gather engine with ``multiprobe=4``
     (recall@10 not below T=1's; top-k and top-p of 256 queries equal to
     a CPU copy);
   - cross-polytope: 32 bands x 8 rows at 2**20 slots with an int8 payload
     (collision top-k on B1 at 32 band words, top-p gather, self-match,
     card == CPU copy, recall@10, QPS; ``engine="hamming"`` raises);
   - filters: an allowlist of 10% of the ids minus a denylist of 1,000 at
     100k (B1), 1M planes (B2) and 1M packed (B3): no inadmissible id,
     ids equal to a CPU copy under the same filter (64 queries on the
     packed store, whose filtered B3 keys are also held to the plain
     version on the card) and to brute force over the admitted subset, the
     filter's state cached and recomputed
     after a delete, filtered top-p on both engines, filtered QPS;
   - save / ``load_from_disk(device="cuda")`` of a structured and two
     cross-polytope indexes (``diagonals.npz``; multiprobe 2 and 4).

Every launch counter is reset just before each path of phases 3-5, 7 and
8 and read just after it; each path must launch its kernel. Then it prints
the nvidia-smi line, one JSON line with the kernels (launches, error, ms,
plain, bound and library ms; B1 once per timed instantiation), and last ``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero without that last line; it also exits non-zero when no
CUDA device is available.
"""

from __future__ import annotations

import argparse
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DIM, NUM_PERM, NUM_BANDS, ROWS = 768, 256, 16, 16
TOP_K = 10
N_100K = 100_000
N_1M = 1 << 20
N_4M = 1 << 22
INGEST_BATCH = 1 << 16
QPS_BATCH_100K = 16384
QPS_BATCH_1M = 8192
CARRY_QUERIES = 256
TOPP_BATCH_100K = 1024
TOPP_QUERIES = 1024
TOPP_QPS_BATCHES_1M = (1024, 8192)
# recall@10 of top-p against exact float32 cosine on the 1M clustered data
# with an int8 payload: measured 0.7459 for both engines on an H100 (seed 0).
RECALL_FLOOR_1M = 0.70
DEVICE = "cuda"
# Peak rates of one H100 SXM at its 700 W limit, for each kernel's bound:
# int8 tensor cores and HBM from NVIDIA's data sheet; int32 ALU lanes and
# __popc issue slots per clock per SM at the 1.98 GHz boost clock.
H100_INT8_OPS = 1.979e15
H100_HBM_BYTES = 3.35e12
H100_INT32_OPS = 64 * 132 * 1.98e9
H100_POPC_OPS = 16 * 132 * 1.98e9
# The kernels' wrappers in lshrs_tpu_torch.ops.group_max: B1, B2, B3.
KERNELS = ("group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys")
B1, B2, B3 = KERNELS
# B1's timed multi-probe and 32-word cases (num_bands, words, C, Q, probes),
# each one a line of the kernels record.
B1_VARIANTS = {
    (16, 1, 131072, 1024, 2): "group_max_keys@bw16_probes2",
    (16, 1, 131072, 1024, 4): "group_max_keys@bw16_probes4",
    (32, 1, 131072, 1024, 1): "group_max_keys@bw32_probes1",
    (32, 1, 131072, 1024, 2): "group_max_keys@bw32_probes2",
    (32, 1, 131072, 1024, 4): "group_max_keys@bw32_probes4",
}
# B1 at the shapes the 2**20-slot paths launch it with, timed beside the
# table above: the gather rerank's 256-query slices.
B1_TIMED_1M = {
    (16, 1, N_1M, 256, 1): "group_max_keys@gather_1m",
    (16, 1, N_1M, 256, 4): "group_max_keys@gather_1m_probes4",
    (32, 1, N_1M, 256, 1): "group_max_keys@gather_1m_bw32",
}
# Plain B1 holds a (Q, C) int32 key matrix: past this many elements it is
# run over slices of the queries.
B1_PLAIN_ELEMENTS = 1 << 28
CP_BANDS, CP_ROWS = 32, 8
HASH_ROWS = 1 << 16
FILTER_DENY = 1000
PACKED_CPU_QUERIES = 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_bound(name: str, shape: dict) -> tuple[float, str]:
    """The least time (ms) the H100 could take for a kernel's work at
    ``shape``, and what sets it: the larger of the operations at their peak
    rate and the bytes (each input read once, the output written once) at
    the HBM rate."""
    c, q = shape["C"], shape["Q"]
    if name.startswith("group_max_keys"):  # B1: a compare and an add per band word
        bw, probes = shape["bands"], shape["probes"]
        ops, rate = 2 * q * c * probes * bw, H100_INT32_OPS
        nbytes = 4 * (bw * c + c + q * probes * bw + q * (c // 64))
    elif name.startswith("hamming_group_max_keys"):  # B2: int8 multiply-adds
        from lshrs_tpu_torch.ops.hamming import plane_width

        p, width = shape["P"], plane_width(shape["P"])
        ops, rate = 2 * q * c * p, H100_INT8_OPS
        nbytes = c * width + 4 * c + q * width + 4 * q * (c // shape["group"])
    else:  # B3: one popcount per (query, slot, word)
        bw = shape["BW"]
        ops, rate = q * c * bw, H100_POPC_OPS
        nbytes = 4 * (bw * c + c + q * bw + q * (c // shape["group"]))
    op_ms, byte_ms = ops / rate * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def median_ms(fn, *, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def b1_inputs(rng, *, bw, c, q, probes, dev):
    """Store words from a 4-letter alphabet (so counts spread over 0..B),
    planted full matches, ~10% dead slots; probe t > 0 flips bit t-1 of
    probe 0, keeping a band's probes pairwise distinct."""
    from lshrs_tpu_torch.ops.scan import global_tie_core

    sig = rng.integers(0, 4, (bw, c), dtype=np.int32)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    q0 = rng.integers(0, 4, (q, bw), dtype=np.int32)
    planted = rng.integers(0, c, q // 4)
    q0[: q // 4] = sig[:, planted].T
    qw = np.concatenate([q0 ^ (np.int32(1) << t) if t else q0 for t in range(probes)], 1)
    sig_t = torch.from_numpy(sig).to(dev)
    tie = global_tie_core(torch.from_numpy(ids).to(dev))
    return sig_t, tie, torch.from_numpy(np.ascontiguousarray(qw)).to(dev)


def b2_inputs(rng, *, c, p, q, asymmetric, dev):
    """+-1 planes and queries (or quantised asymmetric queries), zero-padded
    to the store's plane width, as the store holds them; ~10% dead slots."""
    from lshrs_tpu_torch.ops.hamming import plane_width
    from lshrs_tpu_torch.ops.scan import global_tie_core

    pad = ((0, 0), (0, plane_width(p) - p))
    planes = (2 * rng.integers(0, 2, (c, p), dtype=np.int8) - 1).astype(np.int8)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    if asymmetric:
        qb = rng.integers(-127, 128, (q, p), dtype=np.int16).astype(np.int8)
    else:
        qb = planes[rng.integers(0, c, q)].copy()
        qb[q // 2 :] *= np.where(rng.random((q - q // 2, p)) < 0.2, -1, 1).astype(np.int8)
    return (
        torch.from_numpy(np.pad(planes, pad)).to(dev),
        global_tie_core(torch.from_numpy(ids).to(dev)),
        torch.from_numpy(np.pad(qb, pad)).to(dev),
    )


def b3_inputs(rng, *, bw, c, q, dev):
    """Full 32-bit store words (so num_perm = 32 * BW), ~10% dead slots;
    half the queries are stored slots with ~10% of their bits flipped."""
    from lshrs_tpu_torch.ops.scan import global_tie_core

    sig = rng.integers(-(2**31), 2**31, (bw, c), dtype=np.int64).astype(np.int32)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    qw = rng.integers(-(2**31), 2**31, (q, bw), dtype=np.int64).astype(np.int32)
    flips = (rng.random((q // 2, bw, 32)) < 0.1).astype(np.int64) << np.arange(32)
    qw[: q // 2] = sig[:, rng.integers(0, c, q // 2)].T ^ flips.sum(-1).astype(np.uint32).view(np.int32)
    return (
        torch.from_numpy(sig).to(dev),
        global_tie_core(torch.from_numpy(ids).to(dev)),
        torch.from_numpy(qw).to(dev),
    )


def phase_kernels(rng, dev) -> dict:
    """Phase 2: every kernel against its plain version, bit-exact; returns
    the worst |kernel - plain| per kernel and the timed cases."""
    from lshrs_tpu_torch.ops.group_max import (
        asymmetric_shift,
        group_max_keys,
        group_max_keys_ref,
        hamming_group_max_keys,
        hamming_group_max_keys_ref,
        hamming_packed_group_max_keys,
        hamming_packed_group_max_keys_ref,
        key_scale,
    )

    err = {name: 0 for name in KERNELS}
    timed = {}
    b1_cases = [  # (num_bands, words, C, Q, probes)
        (16, 1, 131072, 1024, 1),
        (16, 1, 131072, 1024, 2),
        (16, 1, 131072, 1000, 1),  # ragged Q: not a multiple of 128
        (4, 3, 16384, 200, 1),     # generic (non-register) instantiation
        (16, 1, N_1M, 256, 1),     # the gather rerank's slice at 1M slots
        (16, 1, N_1M, 200, 1),     # ragged
        (16, 1, 131072, 1024, 4),  # multi-probe, registers <16, 1, 4>
        (32, 1, 131072, 1024, 1),  # 32 band words (cross-polytope at dim 768)
        (32, 1, 131072, 1024, 2),
        (32, 1, 131072, 1024, 4),
        (32, 1, 131072, 1000, 4),  # ragged
        (16, 2, 131072, 1024, 4),  # generic instantiation with probes
        (16, 1, N_1M, 256, 4),     # multiprobe4_1m: the gather rerank's slice
        (16, 1, N_1M, 200, 4),     # ragged
        (32, 1, N_1M, 256, 1),     # cp_1m: the gather rerank's slice
        (32, 1, N_1M, 200, 1),     # ragged
        (32, 1, N_1M, QPS_BATCH_1M, 1),  # cp_1m: the top-k serving batch
    ]
    for nb, w, c, q, probes in b1_cases:
        sig_t, tie, qw = b1_inputs(rng, bw=nb * w, c=c, q=q, probes=probes, dev=dev)
        kw = dict(num_bands=nb, words=w, group=64, scale=key_scale(c), probes=probes)
        got = group_max_keys(sig_t, tie, qw, **kw)
        step = max(1, B1_PLAIN_ELEMENTS // c)
        diff, ok = 0, True
        for s in range(0, q, step):
            want = group_max_keys_ref(sig_t, tie, qw[s : s + step], **kw)
            diff = max(diff, int((got[s : s + step].long() - want.long()).abs().max()))
            ok = ok and torch.equal(got[s : s + step], want)
        torch.cuda.synchronize()
        err["group_max_keys"] = max(err["group_max_keys"], diff)
        emit("kernel_check", kernel="group_max_keys", bands=nb, words=w, C=c, Q=q,
             probes=probes, equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B1 kernel != plain at {(nb, w, c, q, probes)}")
        if (nb, w, c, q, probes) in B1_TIMED_1M:
            timed[B1_TIMED_1M[nb, w, c, q, probes]] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb, probes=probes), None,
            )
        variant = B1_VARIANTS.get((nb, w, c, q, probes))
        if variant:
            timed[variant] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb * w, probes=probes), None,
            )
        if (nb, w, c, q, probes) == (16, 1, 131072, 1024, 1):
            timed["group_max_keys"] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb, probes=probes), None,
            )

    c = 1 << 20
    scale = key_scale(c)
    b2_cases = [  # (P, Q, group, asymmetric)
        (NUM_PERM, 512, 64, False),
        (NUM_PERM, 512, 64, True),
        (NUM_PERM, 300, 64, False),   # ragged Q
        (512, 512, 128, False),       # the widest resident planes, group 128
        (30, 300, 16, True),          # padded 30 -> 32 columns
        (NUM_PERM, QPS_BATCH_1M, 64, False),  # the 1M serving batch
    ]
    for p, q, group, asym in b2_cases:
        planes, tie, qb = b2_inputs(rng, c=c, p=p, q=q, asymmetric=asym, dev=dev)
        kw = dict(group=group, scale=scale, num_perm=p)
        if asym:
            kw.update(offset=p * 127, shift=asymmetric_shift(p, c))
        got = hamming_group_max_keys(planes, tie, qb, **kw)
        want = hamming_group_max_keys_ref(planes, tie, qb, **kw)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        err["hamming_group_max_keys"] = max(err["hamming_group_max_keys"], diff)
        ok = torch.equal(got, want)
        emit("kernel_check", kernel="hamming_group_max_keys", C=c, P=p, width=planes.shape[1],
             Q=q, group=group, asymmetric=asym, shift=kw.get("shift", 1), equal=ok,
             max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B2 kernel != plain at P={p}, Q={q}, group={group}, "
                                 f"asymmetric={asym}")
        shape = dict(C=c, Q=q, P=p, group=group)
        if (p, q, group, asym) == (NUM_PERM, 512, 64, False):
            # torch._int_mm: the same int8 product, no key and no group
            # max, writing the whole (Q, C) int32 matrix; timed only.
            timed["hamming_group_max_keys"] = (
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys(planes, tie, qb, **kw),
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys_ref(planes, tie, qb, **kw),
                shape, lambda planes=planes, qb=qb: torch._int_mm(qb, planes.t()),
            )
        if q == QPS_BATCH_1M:
            timed["hamming_group_max_keys@serving_1m"] = (
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys(planes, tie, qb, **kw),
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys_ref(planes, tie, qb, **kw),
                shape, None,
            )
        del planes, qb, got, want

    b3_cases = [  # (BW, C, Q, group)
        (16, 1 << 20, 512, 64),
        (16, 1 << 20, 300, 64),  # ragged Q
        (8, 1 << 18, 512, 32),   # the BW=8 instantiation
        (12, 1 << 16, 200, 128), # generic (non-register) instantiation
        (16, 1 << 16, 100, 16),
    ]
    for bw, c, q, group in b3_cases:
        sig_t, tie, qw = b3_inputs(rng, bw=bw, c=c, q=q, dev=dev)
        kw = dict(num_perm=32 * bw, group=group, scale=key_scale(c))
        got = hamming_packed_group_max_keys(sig_t, tie, qw, **kw)
        want = hamming_packed_group_max_keys_ref(sig_t, tie, qw, **kw)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        err["hamming_packed_group_max_keys"] = max(err["hamming_packed_group_max_keys"], diff)
        ok = torch.equal(got, want)
        emit("kernel_check", kernel="hamming_packed_group_max_keys", BW=bw, C=c, Q=q,
             group=group, equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B3 kernel != plain at {(bw, c, q, group)}")
        if (bw, c, q) == (16, 1 << 20, 512):
            timed["hamming_packed_group_max_keys"] = (
                lambda a=(sig_t, tie, qw), kw=kw: hamming_packed_group_max_keys(*a, **kw),
                lambda a=(sig_t, tie, qw), kw=kw: hamming_packed_group_max_keys_ref(*a, **kw),
                dict(C=c, Q=q, BW=bw, group=group), None,
            )
    return {"max_abs_err": err, "timed": timed}


def carry_to_cpu(store):
    """A ``device="cpu"`` store loaded from ``store.state_arrays()``."""
    from lshrs_tpu_torch import DeviceStore

    cpu = DeviceStore(
        num_bands=store.num_bands, rows_per_band=store.rows_per_band, dim=store.dim,
        initial_capacity=store._capacity, chunk_size=store.chunk,
        group_size=store.group, dedupe=store.dedupe,
        enable_hamming=store.enable_hamming, hamming_storage=store.hamming_storage,
        store_vectors=store.store_vectors, payload_dtype=store.payload_dtype,
        rerank_engine=store.rerank_engine, rerank_candidates=store.rerank_candidates,
        device="cpu",
    )
    cpu.load_state_arrays(store.state_arrays())
    assert cpu._capacity == store._capacity, (cpu._capacity, store._capacity)
    return cpu


def check_ids(ids: np.ndarray, q: int, n: int) -> None:
    assert ids.shape == (q, TOP_K) and ids.dtype == np.int32, (ids.shape, ids.dtype)
    assert ((ids >= -1) & (ids < n)).all(), "ids out of range"


def self_match(serve, batches, n: int) -> float:
    """Share of stored vectors whose top-1 is their own id (``n`` rows stored)."""
    hits = total = 0
    for ids, x in batches:
        out = serve(x)
        check_ids(out, len(ids), n)
        hits += int((out[:, 0] == ids).sum())
        total += len(ids)
    return hits / total


def serving_qps(serve, queries, *, trials: int = 3) -> float:
    serve(queries[0])  # warm
    rates = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in queries:
            serve(x)  # returns host ids: synchronised
        rates.append(sum(len(x) for x in queries) / (time.perf_counter() - t0))
    return float(np.median(rates))


def serving_profile(serve, queries, *, top: int = 8) -> dict:
    """Device time by kernel over the serving batches (torch.profiler):
    per-batch device and wall ms, the device-busy share, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # warm: the first session starts the tracer
        serve(queries[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for x in queries:
            serve(x)
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / len(queries)
    return {
        "wall_ms_per_batch": wall_ms,
        "device_ms_per_batch": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "top": [
            {"name": e.key[:90], "ms_per_batch": e.self_device_time_total / 1e3 / len(queries),
             "calls_per_batch": e.count / len(queries)}
            for e in dev[:top]
        ],
    }


def phase_100k(seed: int) -> dict:
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys, hamming_group_max_keys

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                device=DEVICE)
    lsh.index(np.arange(INGEST_BATCH), X[:INGEST_BATCH])  # warm-up, untimed
    lsh.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, N_100K, INGEST_BATCH):
        lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    serve = lsh.serving_fn(top_k=TOP_K)
    batches = [
        (np.arange(i, min(i + QPS_BATCH_100K, N_100K)), X[i : i + QPS_BATCH_100K])
        for i in range(0, N_100K, QPS_BATCH_100K)
    ]
    sm = self_match(serve, batches, N_100K)
    stats = lsh.stats()
    b1, b2 = group_max_keys.launches, hamming_group_max_keys.launches
    emit("slice_100k", capacity=stats["index"]["capacity"], ranking=stats["ranking"],
         engine_resolved=stats["engine_resolved"], self_match=sm,
         b1_launches=b1, b2_launches=b2)
    assert sm == 1.0, f"self-match {sm} at 100k"
    assert stats["engine_resolved"] is None and stats["ranking"] == "collision"
    assert b1 > 0 and b2 == 0, (b1, b2)

    # The same query words through the card and through a CPU copy.
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qwords = lsh._hasher.hash_batch_words(qx)
    counts_gpu, ids_gpu = lsh._storage.query_topk(qwords, TOP_K)
    cpu = carry_to_cpu(lsh._storage)
    counts_cpu, ids_cpu = cpu.query_topk(qwords.cpu(), TOP_K)
    equal = bool(np.array_equal(ids_gpu, ids_cpu) and np.array_equal(counts_gpu, counts_cpu))
    emit("carry_100k", queries=CARRY_QUERIES, equal=equal,
         nonzero_counts=int((counts_gpu > 0).sum()))
    assert equal, "100k: card and CPU ids differ on the same words"

    queries = [rng.standard_normal((QPS_BATCH_100K, DIM), dtype=np.float32) for _ in range(6)]
    return {"lsh": lsh, "serve": serve, "queries": queries, "X": X,
            "build_vectors_per_s": N_100K / build_s, "build_s": build_s}


def clustered_1m(seed: int):
    """The 1M slice's data: 2**20 vectors around 4096 gaussian centres
    (0.35 noise; a Gaussian mixture, as the reference's 1M bench row),
    drawn on the host in index batches. Returns ``(rng, centers,
    batches)``; the same seed gives the same vectors."""
    rng = np.random.default_rng(seed + 1)
    centers = rng.standard_normal((4096, DIM), dtype=np.float32)

    def batches():
        for off in range(0, N_1M, INGEST_BATCH):
            xb = centers[rng.integers(0, 4096, INGEST_BATCH)]
            xb += 0.35 * rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)
            yield off, xb

    return rng, centers, batches()


def phase_1m(seed: int) -> dict:
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys

    rng, _, batches = clustered_1m(seed)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                device=DEVICE)
    keep = None
    for off, xb in batches:
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        lsh.index(np.arange(off, off + INGEST_BATCH), xb)
    b2_before = hamming_group_max_keys.launches
    serve = lsh.serving_fn(top_k=TOP_K)
    stats = lsh.stats()
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_1M)
    b2 = hamming_group_max_keys.launches - b2_before
    emit("slice_1m", capacity=stats["index"]["capacity"], alive=stats["index"]["alive"],
         ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
         self_match=sm, b2_launches=b2)
    assert stats["index"]["alive"] == N_1M
    assert stats["engine_resolved"] == "hamming", stats["engine_resolved"]
    assert b2 > 0 and sm == 1.0, (b2, sm)

    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qwords = lsh._hasher.hash_batch_words(qx)
    ham_gpu, ids_gpu = lsh._storage.query_hamming(qwords, TOP_K)
    cpu = carry_to_cpu(lsh._storage)
    ham_cpu, ids_cpu = cpu.query_hamming(qwords.cpu(), TOP_K)
    equal = bool(np.array_equal(ids_gpu, ids_cpu) and np.array_equal(ham_gpu, ham_cpu))
    emit("carry_1m", queries=CARRY_QUERIES, equal=equal)
    assert equal, "1M: card and CPU ids differ on the same words"
    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(4)]
    return {"lsh": lsh, "serve": serve, "queries": queries}


def _assert_same_topk(name, got, want) -> None:
    """``(hamming, ids)`` pairs of two paths, equal element for element."""
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    emit("packed_vs", other=name, queries=int(got[1].shape[0]), equal=equal)
    assert equal, f"4M: packed path != {name} on the same words"


def phase_packed_4m(seed: int) -> dict:
    """The packed-Hamming slice at 2**22 slots (kernel B3, no bitplanes)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import (
        hamming_group_max_keys,
        hamming_group_max_keys_ref,
        hamming_packed_group_max_keys,
        hamming_packed_group_max_keys_ref,
        key_scale,
    )
    from lshrs_tpu_torch.ops.hamming import _select_refine, hamming_topk_core

    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                hamming_storage="packed", device=DEVICE)
    # Clustered data as in the 1M slice (4096 centres, 0.35 noise), drawn
    # on the card: 12 GB of float32 would take minutes on the host.
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    centers = torch.randn((4096, DIM), generator=gen, device=DEVICE)
    keep = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for off in range(0, N_4M, INGEST_BATCH):
        pick = torch.randint(0, 4096, (INGEST_BATCH,), generator=gen, device=DEVICE)
        xb = centers[pick] + 0.35 * torch.randn((INGEST_BATCH, DIM), generator=gen, device=DEVICE)
        xb = xb.cpu().numpy()
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        lsh.index(np.arange(off, off + INGEST_BATCH), xb)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del centers

    store = lsh._storage
    serve = lsh.serving_fn(top_k=TOP_K)
    b2_0, b3_0 = hamming_group_max_keys.launches, hamming_packed_group_max_keys.launches
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_4M)
    b2 = hamming_group_max_keys.launches - b2_0
    b3 = hamming_packed_group_max_keys.launches - b3_0
    stats = lsh.stats()
    emit("slice_packed_4m", capacity=stats["index"]["capacity"], alive=stats["index"]["alive"],
         ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
         hamming_storage=stats["index"]["hamming_storage"],
         hamming_plane_bytes=stats["index"]["hamming_plane_bytes"],
         self_match=sm, b3_launches=b3, b2_launches=b2, build_s=build_s)
    assert stats["index"]["capacity"] == N_4M and stats["index"]["alive"] == N_4M
    assert stats["engine_resolved"] == "hamming", stats["engine_resolved"]
    assert stats["index"]["hamming_plane_bytes"] == 0 and store._planes is None
    assert b3 > 0 and b2 == 0 and sm == 1.0, (b3, b2, sm)

    # The bitplane path (kernel B2) and the plain versions on the same words.
    planes = store._materialize_planes()
    p, group, narrow_r = NUM_PERM, store._group(), store._refine_narrow_r

    def packed_topk(qw):
        with store._lock:
            return store._query_hamming_dev(qw, TOP_K)

    def planes_topk(qw):
        with store._lock:
            store._ensure_ranks()
            return hamming_topk_core(
                planes, store._tie, store._planes_rows(qw), qw, store._refine_rows(),
                k=TOP_K, group=group, narrow_r=narrow_r, num_perm=p,
            )

    def plain_topk(qw, *, packed):
        with store._lock:
            store._ensure_ranks()
            scale = key_scale(store._capacity)
            if packed:
                gmax = hamming_packed_group_max_keys_ref(
                    store._sig_t, store._tie, qw, num_perm=p, group=group, scale=scale)
            else:
                gmax = hamming_group_max_keys_ref(planes, store._tie, store._planes_rows(qw),
                                                  group=group, scale=scale, num_perm=p)
            return _select_refine(gmax, qw, store._refine_rows(), p=p, k=TOP_K, group=group,
                                  narrow_r=narrow_r)

    rng = np.random.default_rng(seed + 3)
    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    qwords = lsh._hasher.hash_batch_words(qx)

    def check_paths():
        got = packed_topk(qwords)
        _assert_same_topk("planes (B2)", got, planes_topk(qwords))
        _assert_same_topk("plain B3", packed_topk(qwords[:64]), plain_topk(qwords[:64], packed=True))
        _assert_same_topk("plain B2", packed_topk(qwords[:64]), plain_topk(qwords[:64], packed=False))

    check_paths()

    deleted = rng.choice(N_4M, N_4M // 100, replace=False)
    lsh.delete(deleted.tolist())
    serve = lsh.serving_fn(top_k=TOP_K)
    out = serve(keep)
    kept = ~np.isin(np.arange(QPS_BATCH_1M), deleted)
    leaked = int(np.isin(out, deleted).sum())
    sm_after = float((out[kept, 0] == np.arange(QPS_BATCH_1M)[kept]).mean())
    stats = lsh.stats()
    emit("delete_packed_4m", deleted=int(deleted.size), deleted_queried=int((~kept).sum()),
         tombstones=stats["index"]["tombstones"], alive=stats["index"]["alive"],
         deleted_ids_returned=leaked, survivor_self_match=sm_after)
    assert leaked == 0 and sm_after == 1.0 and stats["index"]["tombstones"] == deleted.size
    check_paths()

    def serve_planes(x):
        qw = lsh._hasher.hash_batch_words(np.asarray(x, dtype=np.float32))
        return planes_topk(qw)[1].cpu().numpy()

    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(2)]
    return {"lsh": lsh, "serve": serve, "serve_planes": serve_planes, "queries": queries,
            "build_s": build_s}


def phase_lifecycle(s100: dict, seed: int) -> None:
    """Save/load and delete/compact on the 100k collision index."""
    from lshrs_tpu_torch import LSHRS

    lsh, X = s100["lsh"], s100["X"]
    rng = np.random.default_rng(seed + 4)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        lsh.save_to_disk(ckpt)
        back = LSHRS.load_from_disk(ckpt, device=DEVICE)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    want = lsh.query_batch(qx, top_k=TOP_K)
    equal = back.query_batch(qx, top_k=TOP_K) == want
    emit("save_load_100k", queries=CARRY_QUERIES, equal=equal,
         capacity=back.stats()["index"]["capacity"], device=back.stats()["device"])
    assert equal, "100k: the loaded index returns other ids"
    assert back.stats()["index"]["capacity"] == lsh.stats()["index"]["capacity"]
    del back

    deleted = rng.choice(N_100K, 1000, replace=False)
    lsh.delete(deleted.tolist())
    reclaimed = lsh.compact()
    serve = lsh.serving_fn(top_k=TOP_K)
    survivors = np.setdiff1d(np.arange(N_100K), deleted)
    hits = leaked = 0
    for i in range(0, survivors.size, QPS_BATCH_100K):
        ids = survivors[i : i + QPS_BATCH_100K]
        out = serve(X[ids])
        hits += int((out[:, 0] == ids).sum())
        leaked += int(np.isin(out, deleted).sum())
    sm = hits / survivors.size
    stats = lsh.stats()["index"]
    emit("delete_compact_100k", deleted=int(deleted.size), reclaimed=reclaimed,
         alive=stats["alive"], tombstones=stats["tombstones"], survivor_self_match=sm,
         deleted_ids_returned=leaked)
    assert reclaimed == deleted.size and stats["tombstones"] == 0
    assert stats["alive"] == survivors.size and sm == 1.0 and leaked == 0


def compare_rankings(got, want, *, depth: int = TOP_K, tie: float = 1e-5) -> dict:
    """Two ``(ids, cosines, n)`` top-p results of the same queries: ``n``
    equal, and over each row's first ``min(n, depth)`` entries the ids
    equal except where the two cosines at a position differ by < ``tie``
    (a swap of near-tied neighbours); returns the counts and the largest
    cosine difference."""
    g_ids, g_sims, g_n = (np.asarray(x) for x in got)
    w_ids, w_sims, w_n = (np.asarray(x) for x in want)
    equal = swapped = bad = 0
    max_err = 0.0
    for r in range(len(w_n)):
        k = min(int(w_n[r]), depth)
        diff = np.abs(g_sims[r, :k].astype(np.float64) - w_sims[r, :k])
        max_err = max(max_err, float(diff.max(initial=0.0)))
        same = g_ids[r, :k] == w_ids[r, :k]
        if g_n[r] != w_n[r] or not (same | (diff < tie)).all():
            bad += 1
        elif same.all():
            equal += 1
        else:
            swapped += 1
    return {"rows_equal": equal, "rows_near_tie_swaps": swapped, "rows_bad": bad,
            "max_abs_cos_err": max_err}


def topp_self_match(serve, X, batch: int) -> tuple[float, float]:
    """Share of stored rows whose top-1 is themselves, and the worst
    |cosine - 1| of those top-1s."""
    hits, worst = 0, 0.0
    for i in range(0, len(X), batch):
        ids, sims, _ = serve(X[i : i + batch])
        hits += int((ids[:, 0] == np.arange(i, i + len(ids))).sum())
        worst = max(worst, float(np.abs(sims[:, 0].astype(np.float64) - 1.0).max()))
    return hits / len(X), worst


def phase_topp_100k(s100: dict, seed: int) -> dict:
    """Top-p at 100k, float32 payload: auto resolves to the full engine."""
    from lshrs_tpu_torch import LSHRS

    X = s100["X"]
    rng = np.random.default_rng(seed + 5)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                store_vectors=True, payload_dtype="float32", device=DEVICE)
    for i in range(0, N_100K, INGEST_BATCH):
        lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    store = lsh._storage
    engine = store.stats()["rerank_engine"]
    serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
    sm, worst = topp_self_match(serve, X, TOPP_BATCH_100K)
    emit("topp_100k_self_match", engine=engine, payload=store.stats()["payload_bytes"],
         self_match=sm, max_abs_cos_minus_1=worst)
    assert engine == "full", engine
    assert sm == 1.0 and worst < 1e-5, (sm, worst)

    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    got = serve(qx)
    qwords = lsh._hasher.hash_batch_words(qx)
    cpu = carry_to_cpu(store)
    want = cpu.query_topp_batch(qwords.cpu(), qx, TOP_K)
    agree = compare_rankings(got, want)
    emit("topp_100k_card_vs_cpu", queries=CARRY_QUERIES, **agree)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    del cpu

    def as_arrays(rows, n):
        ids = np.full((len(rows), TOP_K), -1, np.int32)
        sims = np.zeros((len(rows), TOP_K), np.float32)
        for r, row in enumerate(rows):
            ids[r, : len(row[:TOP_K])] = [i for i, _ in row[:TOP_K]]
            sims[r, : len(row[:TOP_K])] = [c for _, c in row[:TOP_K]]
        return ids, sims, np.asarray(n)

    # The batch entry point runs the same device rerank as serving.
    batch = as_arrays(lsh.get_above_p_batch(qx, p=1.0, top_k=TOP_K), got[2])
    agree = compare_rankings(batch, got, tie=0.0)
    emit("topp_100k_batch_vs_serving", queries=CARRY_QUERIES, **agree)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-6, agree

    # One query at a time: get_above_p (device rerank of a single query)
    # and candidate enumeration (top_k=None: the nnz probe, then kernel B1).
    n_enum = [len(lsh.query(x, top_k=None)) for x in qx[:16]]
    single = as_arrays([lsh.get_above_p(x, p=1.0) for x in qx[:16]], n_enum)
    agree = compare_rankings(single, [x[:16] for x in got])
    emit("topp_100k_single_and_enumeration", queries=16, **agree)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    queries = [rng.standard_normal((TOPP_BATCH_100K, DIM), dtype=np.float32) for _ in range(8)]
    return {"lsh": lsh, "serve": serve, "queries": queries, "X": X}


def phase_topp_1m(seed: int) -> dict:
    """Top-p at 2**20 clustered vectors, int8 payload: the full and the
    gather engine in turn; gather == full on every exact query, recall@10
    of each against exact float32 cosine."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    rng, centers, batches = clustered_1m(seed)
    kw = dict(dim=DIM, num_perm=NUM_PERM, store_vectors=True, payload_dtype="int8", device=DEVICE)
    lsh = LSHRS(num_bands=NUM_BANDS, rows_per_band=ROWS, **kw)
    # The same vectors under multiprobe=4 and under the cross-polytope
    # family (32 x 8; never Hamming), both on the gather engine: phase 9.
    others = {
        "multiprobe4": LSHRS(num_bands=NUM_BANDS, rows_per_band=ROWS, multiprobe=4,
                             rerank_engine="gather", **kw),
        "crosspolytope": LSHRS(num_bands=CP_BANDS, rows_per_band=CP_ROWS,
                               hash_family="crosspolytope", rerank_engine="gather", **kw),
    }
    build_s = dict.fromkeys(others, 0.0)
    keep = None
    exact_x = torch.empty((N_1M, DIM), dtype=torch.float32, device=DEVICE)
    for off, xb in batches:
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        lsh.index(np.arange(off, off + INGEST_BATCH), xb)
        exact_x[off : off + INGEST_BATCH] = torch.from_numpy(xb).to(DEVICE)
        for name, other in others.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            other.index(np.arange(off, off + INGEST_BATCH), xb)
            torch.cuda.synchronize()
            build_s[name] += time.perf_counter() - t0
    store = lsh._storage
    qx = centers[rng.integers(0, 4096, TOPP_QUERIES)]
    qx += 0.35 * rng.standard_normal((TOPP_QUERIES, DIM), dtype=np.float32)

    # Exact float32 cosine top-10 over the 2**20 vectors (TF32 is off).
    xn = exact_x / torch.linalg.vector_norm(exact_x, dim=1, keepdim=True)
    qt = torch.from_numpy(qx).to(DEVICE)
    qn = qt / torch.linalg.vector_norm(qt, dim=1, keepdim=True)
    best = torch.full((TOPP_QUERIES, TOP_K), -2.0, device=DEVICE)
    best_ids = torch.zeros((TOPP_QUERIES, TOP_K), dtype=torch.int64, device=DEVICE)
    for s in range(0, N_1M, 1 << 18):
        v, i = torch.topk(qn @ xn[s : s + (1 << 18)].T, TOP_K, dim=1)
        v, j = torch.topk(torch.cat([best, v], 1), TOP_K, dim=1)
        best_ids = torch.cat([best_ids, i + s], 1).gather(1, j)
        best = v
    truth = best_ids.cpu().numpy()
    del exact_x, xn

    # Each engine pinned through the store's batch entry point.
    qw = lsh._hasher.hash_batch_words(qx)
    mc = store.rerank_candidates
    out, result, b1 = {}, {}, {}
    truncations = store.stats()["rerank_truncations"]
    for eng in ("full", "gather"):
        before = group_max_keys.launches
        out[eng] = store.query_topp_batch(qw, qx, TOP_K, engine=eng)
        b1[eng] = group_max_keys.launches - before
    truncations = store.stats()["rerank_truncations"] - truncations
    full, gather = out["full"], out["gather"]
    # A query the gather engine could not cover has n >= max_candidates,
    # so n < max_candidates proves its ranking exact.
    exact = gather[2] < mc
    agree = compare_rankings([x[exact] for x in gather], [x[exact] for x in full], tie=1e-6)
    for eng, res in (("full", full), ("gather", gather)):
        hits = [len(set(res[0][r][res[0][r] >= 0]) & set(truth[r])) for r in range(TOPP_QUERIES)]
        result[eng] = {"recall_at_10": float(np.mean(hits)) / TOP_K,
                       "mean_candidates": float(res[2].mean())}

    # The card against the same store carried to the CPU (full engine,
    # plain torch) on the first CARRY_QUERIES queries.
    t0 = time.perf_counter()
    cpu = carry_to_cpu(store)
    want = cpu.query_topp_batch(qw[:CARRY_QUERIES].cpu(), qx[:CARRY_QUERIES], TOP_K,
                                engine="full")
    cpu_s = time.perf_counter() - t0
    del cpu
    sub = exact[:CARRY_QUERIES]
    vs_cpu = {"full": compare_rankings([x[:CARRY_QUERIES] for x in full], want),
              "gather_on_exact": compare_rankings([x[:CARRY_QUERIES][sub] for x in gather],
                                                  [x[sub] for x in want])}

    # The user's entry point on the gather engine: the same ids, through B1.
    store.rerank_engine = "gather"
    before = group_max_keys.launches
    served = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES)(qx)
    b1["serving_gather"] = group_max_keys.launches - before
    served_equal = bool(np.array_equal(served[0], gather[0])
                        and np.array_equal(served[2], gather[2]))
    emit("topp_1m_int8", queries=TOPP_QUERIES, payload_bytes=store.stats()["payload_bytes"],
         gather_exact=int(exact.sum()), gather_truncations=truncations,
         gather_vs_full_on_exact=agree, card_vs_cpu=vs_cpu, cpu_queries=CARRY_QUERIES,
         cpu_seconds=cpu_s, serving_equals_gather=served_equal, b1_launches=b1, **result)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    for name, a in vs_cpu.items():
        assert a["rows_bad"] == 0 and a["max_abs_cos_err"] < 1e-5, (name, a)
    assert exact.sum() > 0 and truncations <= int((~exact).sum()) and served_equal
    assert b1["full"] == 0 and b1["gather"] > 0 and b1["serving_gather"] > 0, b1
    assert all(RECALL_FLOOR_1M <= r["recall_at_10"] <= 1.0 for r in result.values()), result
    queries = {q: [centers[rng.integers(0, 4096, q)]
                   + 0.35 * rng.standard_normal((q, DIM), dtype=np.float32) for _ in range(2)]
               for q in TOPP_QPS_BATCHES_1M}
    return {"lsh": lsh, "queries": queries, "recall": result, "others": others,
            "others_build_s": build_s, "qx": qx, "truth": truth, "keep": keep, "rng": rng}


def phase_topp_lifecycle(t100: dict, seed: int) -> None:
    """Delete 1,000 ids and compact, then save and load with the payload:
    no deleted id comes back from top-p, and the loaded index returns the
    same top-p ids."""
    from lshrs_tpu_torch import LSHRS

    lsh, X = t100["lsh"], t100["X"]
    rng = np.random.default_rng(seed + 6)
    deleted = rng.choice(N_100K, 1000, replace=False)
    lsh.delete(deleted.tolist())
    reclaimed = lsh.compact()
    serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
    qx = X[deleted]  # the deleted vectors themselves, and noisy neighbours
    qx = np.concatenate([qx, qx + 0.1 * rng.standard_normal(qx.shape, dtype=np.float32)])
    leaked = 0
    for i in range(0, len(qx), TOPP_BATCH_100K):
        leaked += int(np.isin(serve(qx[i : i + TOPP_BATCH_100K])[0], deleted).sum())
    enumerated = sum(int(np.isin(lsh.query(x, top_k=None), deleted).sum()) for x in qx[:16])
    stats = lsh.stats()["index"]
    emit("topp_delete_compact_100k", deleted=int(deleted.size), reclaimed=reclaimed,
         tombstones=stats["tombstones"], alive=stats["alive"], queries=len(qx),
         deleted_ids_returned=leaked, deleted_ids_enumerated=enumerated)
    assert reclaimed == deleted.size and stats["tombstones"] == 0
    assert leaked == 0 and enumerated == 0

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_topp_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        lsh.save_to_disk(ckpt)
        back = LSHRS.load_from_disk(ckpt, device=DEVICE)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    want = serve(qx)
    got = back.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)(qx)
    equal = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[2], want[2]))
    emit("topp_save_load_100k", queries=CARRY_QUERIES, equal=equal,
         payload_bytes=back.stats()["index"]["payload_bytes"], device=back.stats()["device"])
    assert equal, "100k: the loaded index returns other top-p ids"


# ---------------------------------------------------------------------------
# phase 9: hash families, multi-probe, where= filters
# ---------------------------------------------------------------------------

def host_seconds(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def phase_hash_parity(seed: int, label: str) -> None:
    """CUDA == native C == NumPy FWHT words for the structured and the
    cross-polytope family on 65,536 x 768 vectors; probe words host ==
    device at T=4; hash times beside the gaussian matmul's."""
    from lshrs_tpu_torch.hash.crosspolytope import cp_dims_for
    from lshrs_tpu_torch.hash.fwht import _structured_coords_numpy
    from lshrs_tpu_torch.hash.hasher import LSHHasher
    from lshrs_tpu_torch.native import load_fwht_library, native_status
    from lshrs_tpu_torch.ops.bitpack import pack_bits_to_words_np, words_to_numpy

    lib = load_fwht_library()
    emit("native_fwht", status=native_status())
    assert lib is not None, f"the native C FWHT did not load: {native_status()}"
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal((HASH_ROWS, DIM), dtype=np.float32)
    x[:256] = rng.integers(-2, 3, (256, DIM))  # exact magnitude ties
    xd = torch.from_numpy(x).to(DEVICE)
    numpy_rows = {"structured": HASH_ROWS, "crosspolytope": HASH_ROWS // 32}
    probe_rows = HASH_ROWS // 8
    for family, nb, r in (("structured", NUM_BANDS, ROWS), ("crosspolytope", CP_BANDS, CP_ROWS),
                          ("gaussian", NUM_BANDS, ROWS)):
        h = LSHHasher(nb, r, DIM, seed=42, hash_family=family, device=DEVICE)
        dev_words = h.hash_batch_words(xd)
        device_ms = median_ms(lambda h=h: h.hash_batch_words(xd), reps=5)
        host_s, host_words = host_seconds(lambda h=h: h.hash_batch_words_host(x))
        fields = dict(card=label, family=family, bands=nb, rows_per_band=r, rows=HASH_ROWS,
                      device_ms=device_ms, device_vectors_per_s=HASH_ROWS / device_ms * 1e3,
                      host_s=host_s, host_vectors_per_s=HASH_ROWS / host_s)
        if family == "gaussian":
            # A host sgemm and the card's matmul round differently: no
            # parity is claimed; the times stand beside the FWHT's.
            emit("hash", **fields)
            continue
        equal_c = bool(np.array_equal(words_to_numpy(dev_words), host_words))
        n = numpy_rows[family]
        if family == "structured":
            bits = _structured_coords_numpy(x[:n], h.diagonals, nb * r) > 0
        else:
            dpad, cp_d = h.diagonals.shape[2], cp_dims_for(r)
            y = _structured_coords_numpy(x[:n], h.diagonals, nb * dpad)
            y = y.reshape(n, nb, dpad)[:, :, :cp_d]
            i = np.argmax(np.abs(y), axis=2)
            sym = 2 * i + (np.take_along_axis(y, i[:, :, None], axis=2)[:, :, 0] < 0)
            bits = ((sym[..., None] >> np.arange(r)) & 1).astype(bool).reshape(n, -1)
        numpy_words = pack_bits_to_words_np(bits, num_bands=nb, rows_per_band=r)
        equal_np = bool(np.array_equal(numpy_words, host_words[:n]))
        pw_dev = words_to_numpy(h.hash_batch_probe_words(xd[:probe_rows], 4))
        pw_host = h.hash_batch_probe_words_host(x[:probe_rows], 4)
        equal_probe = bool(np.array_equal(pw_dev, pw_host))
        emit("hash", cuda_equals_c=equal_c, c_equals_numpy=equal_np, numpy_rows=n,
             probe_words_equal=equal_probe, probe_rows=probe_rows, **fields)
        assert equal_c, f"{family}: CUDA words != native C words"
        assert equal_np, f"{family}: native C words != NumPy FWHT words"
        assert equal_probe, f"{family}: probe words host != device"


def phase_structured_1m(seed: int, label: str) -> dict:
    """The structured family at 2**20 clustered vectors: host hash (planes
    and packed) and device hash, auto -> Hamming."""
    from lshrs_tpu_torch import LSHRS

    rng, _, batches = clustered_1m(seed)
    kw = dict(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
              hash_family="structured", device=DEVICE)
    idx = {
        "host": LSHRS(hash_mode="host", **kw),
        "device": LSHRS(hash_mode="device", **kw),
        "host_packed": LSHRS(hash_mode="host", hamming_storage="packed", **kw),
    }
    build_s = dict.fromkeys(idx, 0.0)
    keep = None
    for off, xb in batches:
        if keep is None:
            keep = xb[:QPS_BATCH_1M].copy()
        for name, lsh in idx.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lsh.index(np.arange(off, off + INGEST_BATCH), xb)
            torch.cuda.synchronize()
            build_s[name] += time.perf_counter() - t0
    serves = {name: lsh.serving_fn(top_k=TOP_K) for name, lsh in idx.items()}
    qx = keep[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    want = None
    for name, lsh in idx.items():
        stats = lsh.stats()
        sm = self_match(serves[name], [(np.arange(QPS_BATCH_1M), keep)], N_1M)
        out = serves[name](qx)
        emit("slice_structured_1m", hash_mode=name, card=label, capacity=stats["index"]["capacity"],
             ranking=stats["ranking"], engine_resolved=stats["engine_resolved"],
             hamming_storage=stats["index"]["hamming_storage"], self_match=sm,
             build_vectors_per_s=N_1M / build_s[name], build_s=build_s[name])
        assert stats["engine_resolved"] == "hamming" and stats["hash_family"] == "structured"
        assert sm == 1.0, f"structured_1m {name}: self-match {sm}"
        # Host- and device-hashed words are identical, so all three agree.
        if want is None:
            want = out
        assert np.array_equal(out, want), f"structured_1m: {name} != host"
    host = idx["host"]
    qwords = host._hasher.hash_batch_words_host(qx)
    ham_gpu, ids_gpu = host._storage.query_hamming(qwords, TOP_K)
    cpu = carry_to_cpu(host._storage)
    ham_cpu, ids_cpu = cpu.query_hamming(qwords, TOP_K)
    equal = bool(np.array_equal(ids_gpu, ids_cpu) and np.array_equal(ham_gpu, ham_cpu))
    emit("carry_structured_1m", queries=CARRY_QUERIES, equal=equal,
         serving_equals_query=bool(np.array_equal(ids_gpu, want)))
    assert equal and np.array_equal(ids_gpu, want)
    queries = [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(3)]
    return {"idx": idx, "serves": serves, "queries": queries, "keep": keep, "cpu": cpu,
            "rng": rng}


def phase_multiprobe_100k(seed: int, label: str) -> None:
    """multiprobe 2 and 4 on 100k gaussian vectors (kernel B1 with probes)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    queries = [rng.standard_normal((QPS_BATCH_100K, DIM), dtype=np.float32) for _ in range(4)]
    counts_t1 = None
    for probes in (1, 2, 4):
        lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                    engine="collision", multiprobe=probes, device=DEVICE)
        for i in range(0, N_100K, INGEST_BATCH):
            lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
        serve = lsh.serving_fn(top_k=TOP_K)
        before = group_max_keys.launches_by_shape[NUM_BANDS, probes]
        sm = self_match(serve, [(np.arange(QPS_BATCH_100K), X[:QPS_BATCH_100K])], N_100K)
        launched = group_max_keys.launches_by_shape[NUM_BANDS, probes] - before
        pw = lsh._hash_query_words(qx)
        counts, ids = lsh._storage.query_topk(pw, TOP_K)
        cpu = carry_to_cpu(lsh._storage)
        counts_cpu, ids_cpu = cpu.query_topk(pw.cpu(), TOP_K)
        equal = bool(np.array_equal(ids, ids_cpu) and np.array_equal(counts, counts_cpu))
        served_equal = bool(np.array_equal(serve(qx), ids))
        if probes == 1:
            counts_t1, ids_t1, store_t1 = counts, ids, lsh._storage
            grew = None
        else:
            # Every T=1 hit keeps at least its count under T probes: count
            # the T=1 hits' slots again with the probe words.
            full, slot_ids = lsh._storage.query_counts(pw[:32])
            pos = {int(i): s for s, i in enumerate(slot_ids) if i >= 0}
            grew = all(
                full[r, pos[int(i)]] >= c
                for r in range(32) for i, c in zip(ids_t1[r], counts_t1[r]) if c > 0
            )
        qps = serving_qps(serve, queries, trials=2)
        emit("multiprobe_100k", card=label, probes=probes, self_match=sm,
             b1_launches_with_these_probes=launched, card_equals_cpu=equal,
             serving_equals_query=served_equal, counts_kept_or_grew=grew,
             mean_top1_count=float(counts[:, 0].mean()), qps=qps, batch=QPS_BATCH_100K)
        assert sm == 1.0 and launched > 0 and equal and served_equal and grew is not False


def build_profiles(seed: int, label: str) -> None:
    """One 65,536-vector ``index()`` batch with the device hash, by family:
    where the structured build's time goes (FWHT passes) beside the
    gaussian build's (one matmul)."""
    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 11)
    xb = rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)
    for family, nb, r in (("gaussian", NUM_BANDS, ROWS), ("structured", NUM_BANDS, ROWS),
                          ("crosspolytope", CP_BANDS, CP_ROWS)):
        lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=nb, rows_per_band=r, hash_family=family,
                    initial_capacity=4 * INGEST_BATCH, device=DEVICE)
        batch_no = itertools.count()

        def build(x, lsh=lsh, batch_no=batch_no):  # fresh ids each call: appends, no upserts
            i = next(batch_no)
            lsh.index(np.arange(i * INGEST_BATCH, (i + 1) * INGEST_BATCH), x)

        prof = serving_profile(build, [xb, xb], top=6)
        emit("build_profile", card=label, hash_family=family, hash_mode="device",
             batch=INGEST_BATCH, vectors_per_s=INGEST_BATCH / prof["wall_ms_per_batch"] * 1e3,
             **prof)


def recall_at_10(ids: np.ndarray, truth: np.ndarray) -> float:
    hits = [len(set(ids[r][ids[r] >= 0]) & set(truth[r])) for r in range(len(truth))]
    return float(np.mean(hits)) / TOP_K


def phase_probe_and_cp_1m(t1m: dict, label: str) -> None:
    """multiprobe=4 and the cross-polytope family on the 1M int8 data of
    phase 8 (same queries, same exact-cosine truth)."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import group_max_keys

    qx, truth, keep, rng = t1m["qx"], t1m["truth"], t1m["keep"], t1m["rng"]
    t1 = t1m["lsh"]
    t1._storage.rerank_engine = "gather"
    recall = {"multiprobe1": t1m["recall"]["gather"]["recall_at_10"]}
    queries = t1m["queries"][TOPP_QPS_BATCHES_1M[0]]
    qps = {"multiprobe1": serving_qps(
        t1.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES), queries, trials=2)}
    noisy = keep[:CARRY_QUERIES] + 0.2 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    held_by_cpu = {}
    for name, bw, probes in (("multiprobe4", NUM_BANDS, 4), ("crosspolytope", CP_BANDS, 1)):
        lsh = t1m["others"][name]
        store = lsh._storage
        stats = lsh.stats()
        assert stats["index"]["alive"] == N_1M, stats["index"]
        serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES)
        before = group_max_keys.launches_by_shape[bw, probes]
        ids, sims, n = serve(qx)
        launched = group_max_keys.launches_by_shape[bw, probes] - before
        recall[name] = recall_at_10(ids, truth)
        # Self-match through top-p: the vector first, cosine ~1 (int8 payload).
        ids_s, sims_s, _ = serve(keep[:TOPP_QUERIES])
        sm = float((ids_s[:, 0] == np.arange(TOPP_QUERIES)).mean())
        qps[name] = serving_qps(serve, queries, trials=2)
        emit("topp_1m_" + name, card=label, queries=TOPP_QUERIES, recall_at_10=recall[name],
             mean_candidates=float(n.mean()), truncated=int((n >= store.rerank_candidates).sum()),
             self_match=sm, max_abs_cos_minus_1=float(np.abs(sims_s[:, 0] - 1.0).max()),
             b1_launches_at_this_shape=launched, qps=qps[name], batch=TOPP_QPS_BATCHES_1M[0],
             build_vectors_per_s=N_1M / t1m["others_build_s"][name])
        assert launched > 0 and sm == 1.0, (name, launched, sm)
        # The card against the store carried to the CPU: collision top-k
        # and top-p gather (B1 at this (BW, probes) over 2**20 slots).
        qw = lsh._hash_query_words(noisy)
        counts, ids = store.query_topk(qw, TOP_K)
        topp = store.query_topp_batch(qw, noisy, TOP_K)
        cpu_s, cpu = host_seconds(lambda store=store: carry_to_cpu(store))
        qw_cpu = qw.cpu() if isinstance(qw, torch.Tensor) else qw
        query_s, (counts_cpu, ids_cpu) = host_seconds(lambda: cpu.query_topk(qw_cpu, TOP_K))
        topp_cpu = cpu.query_topp_batch(qw_cpu, noisy, TOP_K)
        del cpu
        held_by_cpu[name] = dict(
            equal=bool(np.array_equal(ids, ids_cpu) and np.array_equal(counts, counts_cpu)),
            agree=compare_rankings(topp, topp_cpu), counts=counts, cpu_copy_s=cpu_s)
        emit("card_vs_cpu_1m_" + name, card=label, queries=CARRY_QUERIES, bands=bw, probes=probes,
             topk_card_equals_cpu=held_by_cpu[name]["equal"],
             topp_card_vs_cpu=held_by_cpu[name]["agree"],
             colliding_top1=int((counts[:, 0] > 0).sum()), cpu_copy_s=cpu_s,
             cpu_topk_s=query_s)
        assert held_by_cpu[name]["equal"], f"{name}: card != CPU copy"
        agree = held_by_cpu[name]["agree"]
        assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, (name, agree)
    emit("topp_1m_recall", card=label, **{f"recall_{k}": v for k, v in recall.items()},
         **{f"qps_{k}": v for k, v in qps.items()})
    assert recall["multiprobe4"] >= recall["multiprobe1"], recall

    # Cross-polytope collision top-k (kernel B1 at 32 band words, 2**20 slots).
    cp = t1m["others"]["crosspolytope"]
    store = cp._storage
    assert store._use_grouped() and store.words == CP_BANDS
    serve = cp.serving_fn(top_k=TOP_K)
    before = group_max_keys.launches_by_shape[CP_BANDS, 1]
    sm = self_match(serve, [(np.arange(QPS_BATCH_1M), keep)], N_1M)
    launched = group_max_keys.launches_by_shape[CP_BANDS, 1] - before
    held = held_by_cpu["crosspolytope"]
    equal, agree, counts, cpu_s = (held[k] for k in ("equal", "agree", "counts", "cpu_copy_s"))
    served = serve(qx)
    qps_topk = serving_qps(
        serve, [rng.standard_normal((QPS_BATCH_1M, DIM), dtype=np.float32) for _ in range(2)],
        trials=2)
    emit("slice_cp_1m", card=label, capacity=store._capacity, bands=CP_BANDS, rows_per_band=CP_ROWS,
         self_match=sm, b1_launches_bw32=launched, card_equals_cpu=equal, topp_card_vs_cpu=agree,
         colliding_top1=int((counts[:, 0] > 0).sum()), queries=CARRY_QUERIES,
         topk_recall_at_10=recall_at_10(served, truth), topk_qps=qps_topk, batch=QPS_BATCH_1M,
         cpu_copy_s=cpu_s)
    assert sm == 1.0 and launched > 0 and equal, (sm, launched, equal)
    assert agree["rows_bad"] == 0 and agree["max_abs_cos_err"] < 1e-5, agree
    for bad in (dict(engine="hamming"), dict(enable_hamming=True)):
        try:
            LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=CP_BANDS, rows_per_band=CP_ROWS,
                  hash_family="crosspolytope", device=DEVICE, **bad)
        except ValueError:
            continue
        raise AssertionError(f"cross-polytope accepted {bad}")


def make_filter(n: int, rng):
    """An allowlist of 10% of the ids minus a denylist of 1,000 of them
    (and 1,000 ids outside it)."""
    from lshrs_tpu_torch import IdFilter

    allow = rng.choice(n, n // 10, replace=False)
    deny = np.concatenate([allow[: FILTER_DENY // 2], rng.choice(n, FILTER_DENY // 2)])
    return IdFilter(allowed_ids=allow, disallowed_ids=deny)


def subset_store(store, flt):
    """A store on the card holding only the ids ``flt`` admits (brute
    force over the admitted subset = its unfiltered answers)."""
    from lshrs_tpu_torch import DeviceStore

    state = store.state_arrays()
    keep = flt.admits(state["ids"]) & (state["ids"] >= 0)
    sub = DeviceStore(
        num_bands=store.num_bands, rows_per_band=store.rows_per_band, dim=store.dim,
        initial_capacity=store._capacity, chunk_size=store.chunk, group_size=store.group,
        enable_hamming=store.enable_hamming, hamming_storage=store.hamming_storage,
        device=DEVICE,
    )
    sub.add_signature_batch(state["ids"][keep], state["sig"][keep])
    return sub, int(keep.sum())


def phase_filters(s1m: dict, t1m: dict, seed: int, label: str) -> None:
    """where= at 100k (B1), 1M planes (B2) and 1M packed (B3), and on the
    1M top-p engines."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops import group_max

    rng = np.random.default_rng(seed + 8)
    X = np.random.default_rng(seed).standard_normal((N_100K, DIM), dtype=np.float32)
    lsh100 = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                   engine="collision", device=DEVICE)
    for i in range(0, N_100K, INGEST_BATCH):
        lsh100.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
    # One filter and one set of queries for the two 1M indexes: they hold
    # the same words, so their filtered answers must be equal too.
    flt_1m = make_filter(N_1M, rng)
    noise = 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    cases = [
        ("100k_collision", B1, lsh100, N_100K, X[:QPS_BATCH_100K], QPS_BATCH_100K,
         make_filter(N_100K, rng), None),
        ("1m_planes", B2, s1m["idx"]["host"], N_1M, s1m["keep"], QPS_BATCH_1M, flt_1m,
         s1m["cpu"]),
        ("1m_packed", B3, s1m["idx"]["host_packed"], N_1M, s1m["keep"], QPS_BATCH_1M, flt_1m,
         None),
    ]
    planes_answer = None
    for name, kernel, lsh, n, stored, batch, flt, cpu in cases:
        store = lsh._storage
        wrapper = getattr(group_max, kernel)
        serve = lsh.serving_fn(top_k=TOP_K, where=flt)
        before = wrapper.launches
        out = serve(stored)
        launched = wrapper.launches - before
        got = out[out >= 0]
        inadmissible = int((~flt.admits(got)).sum())
        # An admitted stored vector is its own best match among the admitted.
        adm = flt.admits(np.arange(batch))
        sm = float((out[adm, 0] == np.arange(batch)[adm]).mean())
        # The cached columns are the same tensors as long as nothing
        # recomputed them.
        state = flt.device_state(store)[0]
        serve(stored[:CARRY_QUERIES])
        reused = flt.device_state(store)[0] is state

        qx = stored[:CARRY_QUERIES] + noise
        qw = lsh._hash_words(qx)
        query = store.query_topk if kernel == B1 else store.query_hamming
        score, ids = query(qw, TOP_K, where=flt)
        sub, admitted = subset_store(store, flt)
        sub_query = sub.query_topk if kernel == B1 else sub.query_hamming
        score_sub, ids_sub = sub_query(qw, TOP_K)
        del sub
        brute = bool(np.array_equal(ids, ids_sub) and np.array_equal(score, score_sub))
        if cpu is None:
            cpu = carry_to_cpu(store)
        # The packed plain version runs seconds per query batch on the CPU:
        # fewer queries there, and all of them against it on the card below.
        n_cpu = PACKED_CPU_QUERIES if kernel == B3 else CARRY_QUERIES
        qw_cpu = (qw.cpu() if isinstance(qw, torch.Tensor) else qw)[:n_cpu]
        cpu_query = cpu.query_topk if kernel == B1 else cpu.query_hamming
        cpu_s, (score_cpu, ids_cpu) = host_seconds(lambda: cpu_query(qw_cpu, TOP_K, where=flt))
        del cpu
        cpu_equal = bool(np.array_equal(ids[:n_cpu], ids_cpu)
                         and np.array_equal(score[:n_cpu], score_cpu))
        extra = {}
        if kernel == B3:
            # Kernel B3 on the filtered tie column against its plain version
            # on the card, and the packed index against the planes index
            # (same words, same filter, same queries).
            ids_f, tie_f = flt.device_state(store)
            qw_np = qw.cpu().numpy() if isinstance(qw, torch.Tensor) else np.asarray(qw)
            qw_dev = torch.from_numpy(
                np.ascontiguousarray(qw_np).view(np.int32).reshape(CARRY_QUERIES, -1)).to(DEVICE)
            kw = dict(num_perm=NUM_PERM, group=store._group(),
                      scale=group_max.key_scale(store._capacity))
            counted = wrapper.launches  # a comparison launch is no launch of the path
            keys = group_max.hamming_packed_group_max_keys(store._sig_t, tie_f, qw_dev, **kw)
            wrapper.launches = counted
            plain = group_max.hamming_packed_group_max_keys_ref(store._sig_t, tie_f, qw_dev, **kw)
            extra = dict(
                filtered_keys_equal_plain_on_card=torch.equal(keys, plain),
                dead_under_filter=int((tie_f < 0).sum()),
                equals_planes_index=bool(np.array_equal(ids, planes_answer[1])
                                         and np.array_equal(score, planes_answer[0])))
            del keys, plain
            assert all(v for v in extra.values()), extra
        if kernel == B2:
            planes_answer = (score, ids)
        queries = [rng.standard_normal((batch, DIM), dtype=np.float32) for _ in range(2)]
        qps_f = serving_qps(serve, queries, trials=2)
        qps_u = serving_qps(lsh.serving_fn(top_k=TOP_K), queries, trials=2)
        profile = serving_profile(serve, queries[:1]) if kernel == B2 else None

        # A delete bumps the store's generation: the state is recomputed and
        # the deleted id is gone even though the filter admits it.
        victim = int(np.flatnonzero(adm)[0])
        lsh.delete([victim])
        after = lsh.serving_fn(top_k=TOP_K, where=flt)(stored[:CARRY_QUERIES])
        recomputed = flt.device_state(store)[0] is not state
        gone = victim not in after
        emit("filter_" + name, card=label, kernel=kernel, admitted=admitted, rows=n,
             launches_under_filter=launched, inadmissible_ids_returned=inadmissible,
             admitted_self_match=sm, state_reused=reused, recomputed_after_delete=recomputed,
             deleted_id_gone=gone, equals_brute_force_over_admitted=brute, equals_cpu_copy=cpu_equal,
             cpu_queries=n_cpu, cpu_seconds=cpu_s, queries=CARRY_QUERIES, **extra, qps_filtered=qps_f, qps_unfiltered=qps_u,
             batch=batch)
        if profile:
            emit("profile", card=label, rows=n, batch=batch, engine="hamming", filtered=True,
                 **profile)
        assert launched > 0 and inadmissible == 0 and sm == 1.0, (name, launched, inadmissible, sm)
        assert reused and recomputed and gone and brute and cpu_equal, (
            name, reused, recomputed, gone, brute, cpu_equal)

    # Filtered top-p on the 1M int8 index, both engines.
    lsh, qx = t1m["lsh"], t1m["qx"]
    store = lsh._storage
    flt = make_filter(N_1M, rng)
    qw = lsh._hasher.hash_batch_words(qx)
    out = {eng: store.query_topp_batch(qw, qx, TOP_K, engine=eng, where=flt)
           for eng in ("full", "gather")}
    exact = out["gather"][2] < store.rerank_candidates
    agree = compare_rankings([x[exact] for x in out["gather"]], [x[exact] for x in out["full"]],
                             tie=1e-6)
    ids = out["full"][0]
    inadmissible = int((~flt.admits(ids[ids >= 0])).sum())
    n_unfiltered = store.query_topp_batch(qw, qx, TOP_K, engine="gather")[2]
    qps = {}
    queries = t1m["queries"][TOPP_QPS_BATCHES_1M[0]]
    for eng in ("full", "gather"):
        store.rerank_engine = eng
        for tag, where in (("filtered", flt), ("unfiltered", None)):
            serve = lsh.serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_QUERIES, where=where)
            qps[f"qps_{eng}_{tag}"] = serving_qps(serve, queries, trials=2)
    emit("filter_topp_1m", card=label, queries=TOPP_QUERIES, gather_exact=int(exact.sum()),
         gather_vs_full_on_exact=agree, inadmissible_ids_returned=inadmissible,
         mean_candidates=float(out["full"][2].mean()),
         mean_candidates_unfiltered=float(n_unfiltered.mean()), batch=TOPP_QPS_BATCHES_1M[0], **qps)
    assert agree["rows_bad"] == 0 and inadmissible == 0 and exact.sum() > 0, (agree, inadmissible)
    assert (out["full"][2] <= n_unfiltered).all()


def phase_family_lifecycle(seed: int) -> None:
    """save / load_from_disk(device="cuda") of a structured and a
    cross-polytope index (diagonals.npz), identical ids before and after."""
    from lshrs_tpu_torch import LSHRS

    rng = np.random.default_rng(seed + 10)
    X = rng.standard_normal((N_100K, DIM), dtype=np.float32)
    qx = X[:CARRY_QUERIES] + 0.5 * rng.standard_normal((CARRY_QUERIES, DIM), dtype=np.float32)
    for family, nb, r, probes in (("structured", NUM_BANDS, ROWS, 2),
                                  ("crosspolytope", CP_BANDS, CP_ROWS, 2),
                                  ("crosspolytope", CP_BANDS, CP_ROWS, 4)):
        lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=nb, rows_per_band=r, seed=7,
                    hash_family=family, multiprobe=probes, device=DEVICE)
        for i in range(0, N_100K, INGEST_BATCH):
            lsh.index(np.arange(i, min(i + INGEST_BATCH, N_100K)), X[i : i + INGEST_BATCH])
        ckpt = Path(__file__).resolve().parent / "build" / f"chip_smoke_{family}{probes}_checkpoint"
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            lsh.save_to_disk(ckpt)
            files = sorted(f.name for f in ckpt.iterdir())
            back = LSHRS.load_from_disk(ckpt, device=DEVICE)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        want = lsh.query_batch(qx, top_k=TOP_K)
        equal = back.query_batch(qx, top_k=TOP_K) == want
        same_diags = bool(np.array_equal(back._hasher.diagonals, lsh._hasher.diagonals))
        emit("save_load_family", family=family, files=files, equal=equal, same_diagonals=same_diags,
             multiprobe=back.stats()["multiprobe"], device=back.stats()["device"],
             nonempty=sum(1 for row in want if row))
        assert equal and same_diags and "diagonals.npz" in files and "projections.npz" not in files
        assert back.stats()["multiprobe"] == probes and back.stats()["hash_family"] == family


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        print("chip_smoke: TF32 matmuls must be off for hashing", file=sys.stderr)
        return 1

    from lshrs_tpu_torch.ops import _build

    dev = torch.device(DEVICE)
    label = card_label()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit("card", nvidia_smi=label, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, kernel_build_s=build_s)

    kern = phase_kernels(np.random.default_rng(args.seed), dev)

    # Each path of the main path: counters from zero, read right after.
    from lshrs_tpu_torch.ops import group_max

    wrappers = {name: getattr(group_max, name) for name in KERNELS}
    launches = {name: 0 for name in KERNELS}

    b1_by_shape = {}

    def drive(path: str, kernel, run, *, b1_shapes=()):
        """Run one path with every launch counter at 0 just before it and
        read just after: each kernel named (one name or several) must have
        been launched, and B1 at each ``(BW, probes)`` of ``b1_shapes``."""
        for w in wrappers.values():
            w.launches = 0
        wrappers[B1].launches_by_shape.clear()
        out = run()
        counts = {name: w.launches for name, w in wrappers.items()}
        shapes = dict(wrappers[B1].launches_by_shape)
        emit("launches", path=path, **counts,
             b1_by_bw_probes={f"{bw}x{t}": n for (bw, t), n in sorted(shapes.items())})
        for name in ([kernel] if isinstance(kernel, str) else kernel):
            if counts[name] == 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        for shape in b1_shapes:
            if shapes.get(shape, 0) == 0:
                raise AssertionError(f"B1 was not launched at (BW, probes)={shape} on the {path} path")
        for name, n in counts.items():
            launches[name] += n
        for shape, n in shapes.items():
            b1_by_shape[shape] = b1_by_shape.get(shape, 0) + n
        return out

    s100 = drive("100k", "group_max_keys", lambda: phase_100k(args.seed))
    s1m = drive("1m", "hamming_group_max_keys", lambda: phase_1m(args.seed))
    s4m = drive("packed_4m", "hamming_packed_group_max_keys", lambda: phase_packed_4m(args.seed))

    times = {}
    for name, (run, plain, shape, library) in kern["timed"].items():
        bound_ms, bound_by = kernel_bound(name, shape)
        times[name] = {"ms": median_ms(run), "plain_ms": median_ms(plain),
                       "library_ms": median_ms(library) if library else None,
                       "bound_ms": bound_ms, "bound_by": bound_by, **shape}
        emit("kernel_time", card=label, kernel=name, **times[name])
    qps_100k = serving_qps(s100["serve"], s100["queries"])
    emit("serving", card=label, rows=N_100K, batch=QPS_BATCH_100K, engine="collision",
         qps=qps_100k)
    qps_1m = serving_qps(s1m["serve"], s1m["queries"])
    emit("serving", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         qps=qps_1m)
    # Packed (B3) and planes (B2) on the same 4M store words, in turns.
    for name in ("packed", "planes", "planes", "packed"):
        serve = s4m["serve"] if name == "packed" else s4m["serve_planes"]
        emit("serving", card=label, rows=N_4M, batch=QPS_BATCH_1M, engine="hamming",
             hamming_storage=name, qps=serving_qps(serve, s4m["queries"], trials=2))
    emit("profile", card=label, rows=N_100K, batch=QPS_BATCH_100K, engine="collision",
         **serving_profile(s100["serve"], s100["queries"][:3]))
    emit("profile", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         **serving_profile(s1m["serve"], s1m["queries"][:3]))
    for name in ("packed", "planes"):
        serve = s4m["serve"] if name == "packed" else s4m["serve_planes"]
        emit("profile", card=label, rows=N_4M, batch=QPS_BATCH_1M, engine="hamming",
             hamming_storage=name, **serving_profile(serve, s4m["queries"]))
    emit("build", card=label, rows=N_100K, batch=INGEST_BATCH,
         vectors_per_s=s100["build_vectors_per_s"], seconds=s100["build_s"],
         note="after one warm-up batch; includes host-to-device copies")
    emit("build", card=label, rows=N_4M, batch=INGEST_BATCH, vectors_per_s=N_4M / s4m["build_s"],
         seconds=s4m["build_s"], note="packed store; includes drawing the data on the card "
         "and its round trip through the host")
    del s4m, s1m

    drive("lifecycle_100k", "group_max_keys", lambda: phase_lifecycle(s100, args.seed))

    # Phase 8: top-p rerank.
    t100 = drive("topp_100k", "group_max_keys", lambda: phase_topp_100k(s100, args.seed))
    del s100
    t1m = drive("topp_1m", "group_max_keys", lambda: phase_topp_1m(args.seed))
    # Both engines at 100k too (auto takes full there): with the 1M pair
    # they bracket the full-vs-gather crossover on this card.
    store100 = t100["lsh"]._storage
    for eng in ("full", "gather", "gather", "full"):
        store100.rerank_engine = eng
        serve = t100["lsh"].serving_fn(top_k=TOP_K, mode="topp", batch_hint=TOPP_BATCH_100K)
        emit("serving", card=label, rows=N_100K, batch=TOPP_BATCH_100K, mode="topp",
             engine=eng, payload_dtype="float32", qps=serving_qps(serve, t100["queries"]))
    store100.rerank_engine = "auto"
    lsh1m, store1m = t1m["lsh"], t1m["lsh"]._storage
    serves = {}
    for q in TOPP_QPS_BATCHES_1M:
        for eng in ("full", "gather", "gather", "full"):  # in turns
            store1m.rerank_engine = eng
            serves[eng, q] = lsh1m.serving_fn(top_k=TOP_K, mode="topp", batch_hint=q)
            emit("serving", card=label, rows=N_1M, batch=q, mode="topp", engine=eng,
                 payload_dtype="int8", qps=serving_qps(serves[eng, q], t1m["queries"][q], trials=2))
    for eng in ("full", "gather"):
        emit("profile", card=label, rows=N_1M, batch=TOPP_QPS_BATCHES_1M[-1], mode="topp",
             engine=eng, payload_dtype="int8",
             **serving_profile(serves[eng, TOPP_QPS_BATCHES_1M[-1]],
                               t1m["queries"][TOPP_QPS_BATCHES_1M[-1]][:1]))
    del lsh1m, store1m, serves

    # Phase 9: hash families, multi-probe, filters.
    drive("hash_parity", (), lambda: phase_hash_parity(args.seed, label))
    st1m = drive("structured_1m", (B2, B3), lambda: phase_structured_1m(args.seed, label))
    for name in ("host", "device", "device", "host", "host_packed"):
        emit("serving", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
             hash_family="structured", hash_mode=name,
             qps=serving_qps(st1m["serves"][name], st1m["queries"], trials=2))
    emit("profile", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         hash_family="structured", hash_mode="device",
         **serving_profile(st1m["serves"]["device"], st1m["queries"][:2]))
    build_profiles(args.seed, label)
    drive("multiprobe_100k", B1, lambda: phase_multiprobe_100k(args.seed, label),
          b1_shapes=[(NUM_BANDS, 2), (NUM_BANDS, 4)])
    drive("probe_and_cp_1m", B1, lambda: phase_probe_and_cp_1m(t1m, label),
          b1_shapes=[(NUM_BANDS, 4), (CP_BANDS, 1)])
    drive("filters", KERNELS, lambda: phase_filters(st1m, t1m, args.seed, label))
    del t1m, st1m
    drive("topp_lifecycle_100k", "group_max_keys", lambda: phase_topp_lifecycle(t100, args.seed))
    del t100
    drive("family_lifecycle_100k", B1, lambda: phase_family_lifecycle(args.seed),
          b1_shapes=[(NUM_BANDS, 2), (CP_BANDS, 2), (CP_BANDS, 4)])

    sources = {
        "group_max_keys": ("lshrs_tpu_torch/csrc/collision_group_max.cu",
                           "lshrs_tpu/ops/pallas_scan.py:378"),
        "hamming_group_max_keys": ("lshrs_tpu_torch/csrc/hamming_group_max.cu",
                                   "lshrs_tpu/ops/pallas_scan.py:314"),
        "hamming_packed_group_max_keys": ("lshrs_tpu_torch/csrc/hamming_packed_group_max.cu",
                                          "lshrs_tpu/ops/pallas_scan.py:267"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kern["max_abs_err"][name],
         **{key: times[name][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (src, rep) in sources.items()
    ]
    # B1 once more per timed multi-probe / 32-word instantiation: the same
    # source, its launches on the main path at that (BW, probes).
    src, rep = sources[B1]
    for variant in B1_VARIANTS.values():
        t = times[variant]
        kernels.append(
            {"name": variant, "route": "cuda", "source": src, "replaces": rep,
             "launches": b1_by_shape[t["bands"], t["probes"]],
             "max_abs_err": kern["max_abs_err"][B1],
             **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    print(label)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
