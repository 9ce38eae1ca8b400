"""Smoke test of the PyTorch + CUDA port on one GPU: kernels, then the main path.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the hand-written kernels from ``lshrs_tpu_torch/csrc`` with nvcc
(at first use, into ``build/lshrs_tpu_torch/``), then runs five phases and
prints one JSON line per phase:

1. the card (nvidia-smi name and power limit) and the kernel build time;
2. each kernel against its plain PyTorch version on the card, bit-exact
   (``torch.equal``; tolerance 0: every output is an integer key);
3. the 100k slice: ``LSHRS(dim=768, num_perm=256, num_bands=16,
   rows_per_band=16)`` indexes 100,000 seeded gaussian vectors and serves
   them through ``serving_fn(top_k=10)`` (collision engine, kernel B1):
   self-match must be 1.0, and the store carried to a ``device="cpu"``
   store must return the same ids for the same query words;
4. the 1M slice: the same constructor over 2**20 clustered vectors, where
   ``engine="auto"`` switches to Hamming ranking (kernel B2), with the
   same checks;
5. times: each kernel against its plain version (median CUDA-event ms),
   serving QPS at 100k and 1M, a torch.profiler breakdown of the serving
   batches (device time by kernel, device-busy share), and the 100k build
   rate.

Every launch counter is reset just before phases 3-4 (the main path) and
read just after them. Then it prints the nvidia-smi line, one JSON line
with the kernels, and last ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero without that last line; it
also exits non-zero when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

DIM, NUM_PERM, NUM_BANDS, ROWS = 768, 256, 16, 16
TOP_K = 10
N_100K = 100_000
N_1M = 1 << 20
INGEST_BATCH = 1 << 16
QPS_BATCH_100K = 16384
QPS_BATCH_1M = 8192
CARRY_QUERIES = 256
DEVICE = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    from lshrs_tpu_torch.ops.scan import global_tie_core

    planes = (2 * rng.integers(0, 2, (c, p), dtype=np.int8) - 1).astype(np.int8)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    if asymmetric:
        qb = rng.integers(-127, 128, (q, p), dtype=np.int16).astype(np.int8)
    else:
        qb = planes[rng.integers(0, c, q)].copy()
        qb[q // 2 :] *= np.where(rng.random((q - q // 2, p)) < 0.2, -1, 1).astype(np.int8)
    return (
        torch.from_numpy(planes).to(dev),
        global_tie_core(torch.from_numpy(ids).to(dev)),
        torch.from_numpy(qb).to(dev),
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
        key_scale,
    )

    err = {"group_max_keys": 0, "hamming_group_max_keys": 0}
    timed = {}
    b1_cases = [  # (num_bands, words, C, Q, probes)
        (16, 1, 131072, 1024, 1),
        (16, 1, 131072, 1024, 2),
        (16, 1, 131072, 1000, 1),  # ragged Q: not a multiple of 128
        (4, 3, 16384, 200, 1),     # generic (non-register) instantiation
    ]
    for nb, w, c, q, probes in b1_cases:
        sig_t, tie, qw = b1_inputs(rng, bw=nb * w, c=c, q=q, probes=probes, dev=dev)
        kw = dict(num_bands=nb, words=w, group=64, scale=key_scale(c), probes=probes)
        got = group_max_keys(sig_t, tie, qw, **kw)
        want = group_max_keys_ref(sig_t, tie, qw, **kw)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        err["group_max_keys"] = max(err["group_max_keys"], diff)
        ok = torch.equal(got, want)
        emit("kernel_check", kernel="group_max_keys", bands=nb, words=w, C=c, Q=q,
             probes=probes, equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B1 kernel != plain at {(nb, w, c, q, probes)}")
        if (nb, w, q, probes) == (16, 1, 1024, 1):
            timed["group_max_keys"] = (
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys(sig_t, tie, qw, **kw),
                lambda sig_t=sig_t, tie=tie, qw=qw, kw=kw: group_max_keys_ref(sig_t, tie, qw, **kw),
                dict(C=c, Q=q, bands=nb, probes=probes),
            )

    c, p = 1 << 20, NUM_PERM
    scale = key_scale(c)
    shift = asymmetric_shift(p, c)
    b2_cases = [  # (Q, asymmetric)
        (512, False),
        (512, True),
        (300, False),  # ragged Q
    ]
    for q, asym in b2_cases:
        planes, tie, qb = b2_inputs(rng, c=c, p=p, q=q, asymmetric=asym, dev=dev)
        kw = dict(group=64, scale=scale)
        if asym:
            kw.update(offset=p * 127, shift=shift)
        got = hamming_group_max_keys(planes, tie, qb, **kw)
        want = hamming_group_max_keys_ref(planes, tie, qb, **kw)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        err["hamming_group_max_keys"] = max(err["hamming_group_max_keys"], diff)
        ok = torch.equal(got, want)
        emit("kernel_check", kernel="hamming_group_max_keys", C=c, P=p, Q=q,
             asymmetric=asym, shift=kw.get("shift", 1), equal=ok, max_abs_err=diff)
        if not ok:
            raise AssertionError(f"B2 kernel != plain at Q={q}, asymmetric={asym}")
        if (q, asym) == (512, False):
            timed["hamming_group_max_keys"] = (
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys(planes, tie, qb, **kw),
                lambda planes=planes, tie=tie, qb=qb, kw=kw: hamming_group_max_keys_ref(planes, tie, qb, **kw),
                dict(C=c, Q=q, P=p),
            )
    return {"max_abs_err": err, "timed": timed}


def carry_to_cpu(store):
    """A ``device="cpu"`` store loaded from ``store.state_arrays()``."""
    from lshrs_tpu_torch import DeviceStore

    cpu = DeviceStore(
        num_bands=store.num_bands, rows_per_band=store.rows_per_band, dim=store.dim,
        initial_capacity=store._capacity, chunk_size=store.chunk,
        group_size=store.group, dedupe=store.dedupe,
        enable_hamming=store.enable_hamming, device="cpu",
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
    return {"lsh": lsh, "serve": serve, "queries": queries,
            "build_vectors_per_s": N_100K / build_s, "build_s": build_s}


def phase_1m(seed: int) -> dict:
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys

    rng = np.random.default_rng(seed + 1)
    lsh = LSHRS(dim=DIM, num_perm=NUM_PERM, num_bands=NUM_BANDS, rows_per_band=ROWS,
                device=DEVICE)
    # Clustered data (a Gaussian mixture, as the reference's 1M bench row).
    centers = rng.standard_normal((4096, DIM), dtype=np.float32)
    keep = None
    for off in range(0, N_1M, INGEST_BATCH):
        xb = centers[rng.integers(0, 4096, INGEST_BATCH)]
        xb += 0.35 * rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)
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
    from lshrs_tpu_torch.ops.group_max import group_max_keys, hamming_group_max_keys

    dev = torch.device("cuda", 0)
    label = card_label()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit("card", nvidia_smi=label, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, kernel_build_s=build_s)

    kern = phase_kernels(np.random.default_rng(args.seed), dev)

    # The main path: counters from zero, read right after.
    group_max_keys.launches = 0
    hamming_group_max_keys.launches = 0
    s100 = phase_100k(args.seed)
    s1m = phase_1m(args.seed)
    launches = {
        "group_max_keys": group_max_keys.launches,
        "hamming_group_max_keys": hamming_group_max_keys.launches,
    }
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    times = {}
    for name, (run, plain, shape) in kern["timed"].items():
        times[name] = {"ms": median_ms(run), "plain_ms": median_ms(plain), **shape}
        emit("kernel_time", card=label, kernel=name, **times[name])
    qps_100k = serving_qps(s100["serve"], s100["queries"])
    emit("serving", card=label, rows=N_100K, batch=QPS_BATCH_100K, engine="collision",
         qps=qps_100k)
    qps_1m = serving_qps(s1m["serve"], s1m["queries"])
    emit("serving", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         qps=qps_1m)
    emit("profile", card=label, rows=N_100K, batch=QPS_BATCH_100K, engine="collision",
         **serving_profile(s100["serve"], s100["queries"][:3]))
    emit("profile", card=label, rows=N_1M, batch=QPS_BATCH_1M, engine="hamming",
         **serving_profile(s1m["serve"], s1m["queries"][:3]))
    emit("build", card=label, rows=N_100K, batch=INGEST_BATCH,
         vectors_per_s=s100["build_vectors_per_s"], seconds=s100["build_s"],
         note="after one warm-up batch; includes host-to-device copies")

    sources = {
        "group_max_keys": ("lshrs_tpu_torch/csrc/collision_group_max.cu",
                           "lshrs_tpu/ops/pallas_scan.py:378"),
        "hamming_group_max_keys": ("lshrs_tpu_torch/csrc/hamming_group_max.cu",
                                   "lshrs_tpu/ops/pallas_scan.py:314"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kern["max_abs_err"][name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]
    print(label)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
