"""Cross-polytope throughput bench on one GPU: the recall-best family's cost column.

The port of ``benchmarks/cp_bench.py`` to ``lshrs_tpu_torch``: the same
arguments, defaults, stages and JSON fields. ``LSHRS(hash_family=
"crosspolytope", hash_mode="device")`` with the banding the
cross-polytope tuner chooses (32 x 8 at ``num_perm=256``: 32 one-word
bands, twice the 16 x 16 gaussian words per slot), an int8 payload, and
2**17 gaussian rows of 768 dimensions (``default_rng(0)``) indexed in
2**17-row ``index()`` calls (the raw float32 rows uploaded, the FWHT hash
and the append on the card). The measurements, in the reference's order:

1. ``serving_fn(top_k=10, mode="collision")`` end to end (upload, device
   hash, one dispatch; kernel B1 at 32 band words, ``<32, 1, 1>``), with
   the first ``--query-batch`` stored rows as the self-match probe;
2. the store's ``snapshot_query_fn(10, wire="words")`` on words hashed
   off the timed path and held on the host;
3. the same closure on words already on the card: ms per batch, a
   synchronize after each call (the reference read the ids back);
4. ``serving_fn(mode="topp", batch_hint=Q)`` end to end and the store's
   ``snapshot_topp_fn`` with words and vectors on the card; the engine
   ``auto`` resolves for that batch (``topp_engine_resolved``); the
   gather engine runs B1 once per query slice, the full engine no kernel;
5. the fused device build (``DeviceStore.add_vectors_batch(...,
   hash_family="crosspolytope")`` with ``device_projection()``, the rows
   already on the card), and its rows' self-match against words hashed on
   the host;
6. the host hash rate (``hash_batch_dense_host``, the native C FWHT, which
   must have loaded).

A pipelined trial submits ``--n-batches`` batches to three threads; each
output is read back to the host (``.cpu()``, the completion barrier). The
reference warms the fused index path with a throwaway ``index()`` and
``clear()`` before the timed build: the port keeps that warm-up. Nothing
in the port compiles at first use there (the kernels are built before
the run starts; ``clear()`` re-allocates the store's tensors at the same
capacity), so the timed loops run warm. ``index_build_vectors_per_s``
ends at a synchronize, as the reference's read of 8 ids.

Usage, from the repository root:

    python3 benchmarks/torch_cp_bench.py [--n 131072] [--dim 768] [--num-perm 256]
        [--bands B --rows R] [--query-batch 8192] [--n-batches 6] [--trials 3]
        [--payload float32|bfloat16|int8] [--skip-build] [--skip-topp]
        [--smoke] [--device cuda|cpu]

Prints progress on stderr and one JSON line with the reference's fields
(``platform`` is ``"gpu"``), and adds the card (``nvidia-smi`` name and
power limit), the kernel launches of each timed stage, the run's seconds
and its peak device bytes. Checks: every row indexed; self-match 1.0 on
collision, top-p and the fused build; served ids in ``[-1, n)``; the
native C FWHT loaded; on the card each timed collision call launched B1
once at 32 band words (``<BW, 1, 1>``) and the top-p calls B1 once per
gather slice (none on the full engine), and no other kernel ran. A failed
check prints ``{"check_failed": ...}`` on stderr and exits 1.
``--smoke``: 16,384 rows, 1,024-query batches, 2 batches, 2 trials.
``--device cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_stage_timing as st  # noqa: E402

DATA_SEED = 0
WARM_SEED = 1
STEP = 1 << 17
SMOKE = dict(n=1 << 14, query_batch=1024, n_batches=2, trials=2)


def log(msg: str) -> None:
    print(f"[torch_cp_bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


REPS = 3  # calls per device-resident trial


def pipelined_qps(serve, raw, trials, n):
    """Best and median QPS of ``trials`` pooled trials (one warm call
    first: ``1 + trials * len(raw)`` calls in all); the ids of the first
    trial."""
    st.to_host(serve(raw[0]))
    ts, first = st.repeated_trials(lambda: st.pooled_trial(serve, raw), trials,
                                   q=len(raw[0]), k=10, n=n)
    n_q = sum(q.shape[0] for q in raw)
    return n_q / ts[0], n_q / ts[len(ts) // 2], first


def device_trial(fn, x, device) -> float:
    """Seconds per call of ``fn(x)`` over ``REPS`` calls with the inputs on
    the card, a synchronize after each call."""
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn(x)
        st.sync(device)
    return (time.perf_counter() - t0) / REPS


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import LSHRS, DeviceStore
    from lshrs_tpu_torch.native import load_fwht_library, native_status

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    rng = np.random.default_rng(DATA_SEED)
    lsh = LSHRS(dim=args.dim, num_perm=args.num_perm, num_bands=args.bands,
                rows_per_band=args.rows, hash_family="crosspolytope",
                hash_mode="device",  # the host CP hash is hash-bound (stage 6)
                store_vectors=not args.skip_topp, payload_dtype=args.payload,
                initial_capacity=args.n, dedupe=False, buffer_size=1 << 30, device=device)
    bands = lsh._config["num_bands"]
    rows = lsh._config["rows_per_band"]
    log(f"constructed: {bands}x{rows}, n={args.n}, payload="
        f"{None if args.skip_topp else args.payload}")

    # The reference's warm-up of the fused index path, off the timed
    # path; a separate rng keeps the seed-0 data and query stream.
    warm_rng = np.random.default_rng(WARM_SEED)
    warm = warm_rng.standard_normal((min(STEP, args.n), args.dim)).astype(np.float32)
    lsh.index(np.arange(warm.shape[0]), warm)
    lsh.clear()
    tail = args.n % min(STEP, args.n)
    if tail:
        lsh.index(np.arange(tail), warm[:tail])
        lsh.clear()
    log("fused index path warmed")

    t0 = time.perf_counter()
    X_keep = None
    chunk_rates = []
    for off in range(0, args.n, STEP):
        m = min(STEP, args.n - off)
        xb = rng.standard_normal((m, args.dim)).astype(np.float32)
        if off == 0:
            X_keep = xb[: args.query_batch].copy()
        tc = time.perf_counter()
        lsh.index(np.arange(off, off + m), xb)
        chunk_rates.append(m / (time.perf_counter() - tc))
        log(f"indexed {off + m}/{args.n} ({chunk_rates[-1]:.0f}/s dispatch)")
    st.sync(device)
    build_s = time.perf_counter() - t0
    alive = lsh.stats()["index"]["alive"]
    st.check(alive == args.n, "indexed", {"alive": alive, "n": args.n})
    log(f"build done: {args.n / build_s:.0f} vec/s e2e")

    raw = [rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
           for _ in range(args.n_batches)]
    out = {
        "metric": "crosspolytope_serving",
        "n": args.n,
        "dim": args.dim,
        "banding": f"{bands}x{rows}",
        "payload_dtype": args.payload if not args.skip_topp else None,
        "index_build_vectors_per_s": args.n / build_s,
        # upload + dispatch of each chunk (the card may still be appending):
        # an overlap diagnostic; the end-to-end rate above is synchronised
        "index_build_dispatch_rate_best_chunk": max(chunk_rates),
        "platform": st.platform(device),
    }
    launches = {}

    def measured(name, body, b1: int):
        """``body()``, holding its launches to ``b1`` of B1 and none else."""
        before = st.launch_counts()
        result = body()
        got = launches[name] = st.launch_delta(before) if st.counts_launches(device) else None
        st.expect_launches(name, got, device, b1=b1)
        return result

    pooled_calls = 1 + args.trials * args.n_batches
    device_calls = args.trials * REPS
    ans = {} if answers is None else answers

    # 1. collision top-k serving end to end (device hash + one dispatch)
    serve = lsh.serving_fn(top_k=10, mode="collision")
    probe = serve(X_keep)
    st.check_ids("probe", probe, args.query_batch, 10, args.n)
    out["self_match_rate"] = float((probe[:, 0] == np.arange(args.query_batch)).mean())
    st.check(out["self_match_rate"] == 1.0, "self_match", out["self_match_rate"])
    log(f"self-match {out['self_match_rate']:.3f}; timing collision e2e...")
    best, median, ids_e2e = measured(
        "collision_e2e", lambda: pipelined_qps(serve, raw, args.trials, args.n), pooled_calls)
    out["collision_qps_e2e"], out["collision_qps_e2e_median"] = best, median
    log(f"collision e2e: {best} QPS")

    # 2. store-level engine QPS, words hashed off the timed path
    store, hasher = lsh._storage, lsh._hasher
    serve_store = store.snapshot_query_fn(10, wire="words")
    raw_words = [st.to_host(hasher.hash_batch_words(q)) for q in raw]
    best, median, ids_engine = measured(
        "collision_engine", lambda: pipelined_qps(serve_store, raw_words, args.trials, args.n),
        pooled_calls)
    out["collision_qps_engine"], out["collision_qps_engine_median"] = best, median
    st.check(all(np.array_equal(a, b) for a, b in zip(ids_e2e, ids_engine)), "engine_equal_e2e",
             "the store's closure served other ids than serving_fn")
    log(f"collision engine: {best} QPS")

    # 3. the same closure on words already on the card
    words_dev = torch.from_numpy(raw_words[0]).to(device)
    serve_store(words_dev)
    st.sync(device)
    dts = sorted(measured(
        "collision_device",
        lambda: [device_trial(serve_store, words_dev, device) for _ in range(args.trials)],
        device_calls))
    out["collision_qps_device"] = args.query_batch / dts[0]
    out["collision_ms_device"] = 1000 * dts[0]
    log(f"collision chip-side: {out['collision_qps_device']} QPS")
    state = store.state_arrays()
    ans.update(words=state["sig"], ids=state["ids"],
               capacity=store._capacity, bands=bands, rows=rows, X_keep=X_keep,
               probe_ids=probe, raw=raw, raw_words=raw_words, served=ids_engine)

    # 4. gather-rerank serving (the family's pairing at scale)
    if not args.skip_topp:
        serve_p = lsh.serving_fn(top_k=10, mode="topp", batch_hint=args.query_batch)
        ids_p, cos_p, n_p = serve_p(X_keep)
        st.check_ids("topp_probe", ids_p, args.query_batch, 10, args.n)
        out["topp_self_match_rate"] = float((ids_p[:, 0] == np.arange(args.query_batch)).mean())
        st.check(out["topp_self_match_rate"] == 1.0, "topp_self_match",
                 out["topp_self_match_rate"])
        out["rerank_engine"] = lsh.stats()["index"]["rerank_engine"]
        engine, mc = store._resolve_rerank_engine(None, None, q=args.query_batch)
        slices = -(-args.query_batch // store._topp_dev_batch(engine, mc))
        per_call = slices if engine == "gather" else 0

        def topp_serve(q):
            return serve_p(q)[0]

        best, median, _ = measured(
            "topp_e2e", lambda: pipelined_qps(topp_serve, raw, args.trials, args.n),
            pooled_calls * per_call)
        out["topp_qps"], out["topp_qps_median"] = best, median
        log(f"topp: {best} QPS")

        # 4b. words and query vectors on the card
        serve_tp = store.snapshot_topp_fn(10, wire="words", batch_hint=args.query_batch)
        q_dev = torch.from_numpy(raw[0]).to(device)
        tp = serve_tp(words_dev, q_dev)
        st.sync(device)

        def tp_call(x):
            return serve_tp(words_dev, x)[0]

        dts = sorted(measured(
            "topp_device",
            lambda: [device_trial(tp_call, q_dev, device) for _ in range(args.trials)],
            device_calls * per_call))
        out["topp_qps_device"] = args.query_batch / dts[0]
        out["topp_ms_device"] = 1000 * dts[0]
        out["topp_engine_resolved"] = engine
        log(f"topp chip-side: {out['topp_qps_device']} QPS ({engine})")
        state = store.state_arrays()
        ans.update(payload=state["payload"], topp_probe=(ids_p, cos_p, n_p),
                   topp_device=tuple(st.to_host(x) for x in tp), engine=engine)

    # 5. fused device build (rows already on the card -> one hash + append)
    if not args.skip_build:
        n_b = min(args.n, 1 << 17)
        dstore = DeviceStore(num_bands=bands, rows_per_band=rows, dim=args.dim,
                             initial_capacity=n_b, dedupe=False, device=device)
        X_dev = torch.from_numpy(rng.standard_normal((n_b, args.dim)).astype(np.float32)).to(device)
        proj = hasher.device_projection()
        ids_b = np.arange(n_b)
        dstore.add_vectors_batch(ids_b, X_dev, proj, hash_family="crosspolytope")  # warm

        def timed_build() -> float:
            dstore.clear()
            t0 = time.perf_counter()
            dstore.add_vectors_batch(ids_b, X_dev, proj, hash_family="crosspolytope")
            st.sync(device)
            return time.perf_counter() - t0

        bt = sorted(measured("fused_build", lambda: [timed_build() for _ in range(5)], 0))
        out["fused_build_vectors_per_s"] = n_b / bt[0]
        out["fused_build_vectors_per_s_median"] = n_b / bt[len(bt) // 2]
        # fused rows must self-match host-wire queries bit for bit
        dq = hasher.hash_batch_words_host(st.to_host(X_dev[:1024]))
        _, got = dstore.query_topk(dq, 1)
        out["fused_build_self_match"] = float((got[:, 0] == ids_b[:1024]).mean())
        st.check(out["fused_build_self_match"] == 1.0, "fused_build_self_match",
                 out["fused_build_self_match"])
        log(f"fused build: {out['fused_build_vectors_per_s']} vec/s, "
            f"self-match {out['fused_build_self_match']:.3f}")
        ans.update(fused_words=dstore.state_arrays()["sig"], fused_x=st.to_host(X_dev),
                   fused_host_words=dq)

    # 6. host CP hash rate: the bound of hash_mode="host"
    st.check(load_fwht_library() is not None, "native_fwht_loaded", native_status())
    xh = raw[0][:2048]
    hasher.hash_batch_dense_host(xh)  # warm
    t0 = time.perf_counter()
    hasher.hash_batch_dense_host(xh)
    out["host_hash_vectors_per_s"] = xh.shape[0] / (time.perf_counter() - t0)

    st.emit({**out, "launches": launches, "seconds": time.perf_counter() - t_run,
             "peak_device_bytes": st.peak_bytes(device), "device": dev_card})


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--bands", type=int, default=None)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--query-batch", type=int, default=8192)
    ap.add_argument("--n-batches", type=int, default=6)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--payload", default="int8", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--skip-build", action="store_true", help="skip the fused-build measurement")
    ap.add_argument("--skip-topp", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="16,384 rows, 1,024-query batches, 2 batches, 2 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.query_batch > args.n:
        ap.error("--query-batch must not exceed --n: the probe is the first stored rows")
    device = st.resolve_device(args.device, "torch_cp_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
