"""Scale benchmark on one GPU: 1M-vector index build + query throughput (config #3).

The port of ``benchmarks/scale_bench.py`` to ``lshrs_tpu_torch``: the same
arguments, defaults and JSON fields. It builds a GloVe-1M-scale index
(default 1,048,576 x 256d gaussian rows from ``default_rng(0)``) by
streaming 131,072-row batches through the orchestrator
(``LSHRS(storage=DeviceStore(...)).create_signatures(format="numpy",
prefetch=0)``: hash -> buffer -> device append), once cold and once more
in a fresh instance (the warm build, which is timed), or through a
Parquet file with ``--parquet``; then it serves 8 batches of 8,192
gaussian queries through the reference's pipeline (a hasher thread -> one
dispatch per batch -> a reader thread that reads the ids back with
``.cpu()``). ``--mode scan`` serves ``snapshot_query_fn(10,
mode="collision")`` on kernel B1 (16 band words), ``--mode hamming`` the
bitplane engine on kernel B2, ``--mode bucket`` the sorted-bucket engine
through ``store.query_topk_ids`` (plain torch: no kernel). Queries hash
through the build's own path (``--hash-mode host``: the 32-byte dense
wire; ``device``: words hashed on the card).

Differences from the reference, kept on purpose:

- The reference prints ``stats()["pallas"]``; the port's store has no such
  key (``ROADMAP.md``, "Stats keys"). Its place in the row is taken by
  ``route`` (the kernel the mode serves on, or ``"none"``) and
  ``launches`` (the timed trials' launches by kernel).
- The reference writes ``/tmp/scale_bench.parquet`` once and reuses it
  whatever its ``--n`` or ``--dim``. The port writes the file anew into a
  temporary directory that is removed after the run. ``--parquet`` needs
  ``pyarrow``: without it the run exits 1 and builds nothing.
- ``build_s`` ends at a synchronize (the reference's at a read of 8 ids).

Usage, from the repository root:

    python3 benchmarks/torch_scale_bench.py [--n 1048576] [--dim 256] [--num-perm 256]
        [--batch 131072] [--query-batch 8192] [--n-batches 8] [--trials 2]
        [--bucket-cap 128] [--mode scan|bucket|hamming] [--parquet]
        [--hash-mode host|device] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``; ``pallas`` replaced as above), and adds the card (``nvidia-smi``
name and power limit), the run's seconds, its peak device bytes, and the
card's ms a batch on the first batch's wire held on the card
(``device_ms_per_batch``, CUDA events) beside the best trial's wall ms a
batch (``wall_ms_per_batch``).
Checks: every row indexed, every served id in ``[-1, n)``, each trial
serving the same ids, and on the card exactly one launch per timed batch
of the mode's kernel (B1 at 16 band words for scan, B2 at the symmetric
key for hamming) and none of the others; none at all for bucket. A failed
check prints ``{"check_failed": ...}`` on stderr and exits 1.
``--smoke``: 65,536 rows in 16,384-row batches, 1,024-query batches, 2
batches. ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_stage_timing as st  # noqa: E402

NUM_BANDS = 16
TOP_K = 10
DATA_SEED = 0
SMOKE = dict(n=1 << 16, batch=1 << 14, query_batch=1024, n_batches=2)
ROUTES = {"scan": st.B1, "hamming": st.B2, "bucket": "none"}


def fresh_lsh(args, device):
    from lshrs_tpu_torch import LSHRS, DeviceStore

    store0 = DeviceStore(
        num_bands=NUM_BANDS,
        rows_per_band=args.num_perm // NUM_BANDS,
        dim=args.dim,
        initial_capacity=args.n,
        query_mode=args.mode if args.mode != "hamming" else "scan",
        bucket_cap=args.bucket_cap,
        enable_hamming=args.mode == "hamming",
        dedupe=False,  # streaming build of known-unique ids
        device=device,
    )
    return LSHRS(dim=args.dim, num_perm=args.num_perm, num_bands=NUM_BANDS,
                 rows_per_band=args.num_perm // NUM_BANDS, storage=store0,
                 buffer_size=args.batch * 16, hash_mode=args.hash_mode)


def write_parquet(path: Path, args, rng) -> None:
    """The reference's Parquet file: ``index`` int64 and ``vector`` as a
    fixed-size list, written in ``--batch``-row groups."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    writer = None
    for start in range(0, args.n, args.batch):
        m = min(args.batch, args.n - start)
        vecs = rng.standard_normal((m, args.dim)).astype(np.float32)
        tbl = pa.table({
            "index": pa.array(range(start, start + m), type=pa.int64()),
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(vecs.reshape(-1)), args.dim),
        })
        if writer is None:
            writer = pq.ParquetWriter(path, tbl.schema)
        writer.write_table(tbl)
    writer.close()


def build(args, device, rng, tmp: Path):
    """The index, built as the reference builds it: its LSHRS, build
    seconds and cold build seconds (``None`` for Parquet)."""
    lsh = fresh_lsh(args, device)
    if args.parquet:
        path = tmp / "scale_bench.parquet"
        print("writing parquet ...", file=sys.stderr)
        write_parquet(path, args, rng)
        t0 = time.perf_counter()
        lsh.create_signatures(format="parquet", source=path, batch_size=args.batch)
        st.sync(device)
        return lsh, time.perf_counter() - t0, None
    # Generated outside the timed region: one resident copy, which the
    # loader slices into views.
    all_ids = np.arange(args.n, dtype=np.int64)
    all_vecs = np.empty((args.n, args.dim), dtype=np.float32)
    for start in range(0, args.n, args.batch):
        m = min(args.batch, args.n - start)
        all_vecs[start : start + m] = rng.standard_normal((m, args.dim)).astype(np.float32)

    def timed_build(instance) -> float:
        t0 = time.perf_counter()
        instance.create_signatures(format="numpy", indices=all_ids, vectors=all_vecs,
                                   batch_size=args.batch, prefetch=0)
        st.sync(device)
        return time.perf_counter() - t0

    # Cold (the process's first appends) against a fresh instance's warm build.
    cold_s = timed_build(lsh)
    lsh.close()
    lsh = fresh_lsh(args, device)
    return lsh, timed_build(lsh), cold_s


def run(args, device, answers) -> None:
    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    rng = np.random.default_rng(DATA_SEED)
    with tempfile.TemporaryDirectory(prefix="torch_scale_bench_") as tmp:
        lsh, build_s, cold_s = build(args, device, rng, Path(tmp))
    store, hasher = lsh._storage, lsh._hasher
    alive = lsh.stats()["index"]["alive"]
    st.check(alive == args.n, "indexed", {"alive": alive, "n": args.n})
    build_rate = alive / build_s

    raw = [rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
           for _ in range(args.n_batches)]
    # Queries hash through the build's own path (bit for bit the stored words).
    if args.hash_mode == "host":
        hash_fn, wire = hasher.hash_batch_dense_host, "dense"
    else:
        hash_fn, wire = hasher.hash_batch_words, "words"
    if args.mode == "bucket":
        # The bucketed engine is not part of the snapshot closure: the
        # store's query_mode-aware path serves it.
        if args.hash_mode == "host":
            hash_fn = hasher.hash_batch_words_host

        def serve(qw):
            return store.query_topk_ids(qw, TOP_K)
    else:
        serve = store.snapshot_query_fn(
            TOP_K, wire=wire, mode="hamming" if args.mode == "hamming" else "collision")
    st.check_ids("warm", st.to_host(serve(hash_fn(raw[0]))), args.query_batch, TOP_K, args.n)

    before = st.launch_counts()
    ts, first = st.repeated_trials(lambda: st.pipelined_trial(hash_fn, serve, st.to_host, raw),
                                   args.trials, q=args.query_batch, k=TOP_K, n=args.n)
    launches = st.launch_delta(before) if st.counts_launches(device) else None
    calls = args.trials * args.n_batches
    if args.mode == "scan":
        st.expect_launches(f"{args.mode}_timed", launches, device, b1=calls)
    elif args.mode == "hamming":
        from lshrs_tpu_torch.ops.hamming import plane_width

        st.expect_launches(f"{args.mode}_timed", launches, device, b2=calls,
                           b2_packing=(plane_width(args.num_perm), args.num_perm, 1))
    else:
        st.expect_launches(f"{args.mode}_timed", launches, device)
    qps = args.n_batches * args.query_batch / ts[0]
    wire_dev = torch.as_tensor(hash_fn(raw[0])).to(device)
    device_ms = st.device_ms_per_call(lambda: serve(wire_dev), device)

    stats = lsh.stats()["index"]
    if answers is not None:
        state = store.state_arrays()
        answers.update(words=state["sig"], ids=state["ids"], capacity=store._capacity,
                       wire=[st.to_host(hash_fn(q)) for q in raw], served=first)
    st.emit({
        "n_indexed": alive,
        "dim": args.dim,
        "via": "parquet" if args.parquet else "arrays",
        "mode": args.mode,
        "hash_mode": args.hash_mode,
        "build_s": build_s,
        "build_vectors_per_s": build_rate,
        "build_cold_s": cold_s,
        "query_qps": qps,
        "platform": st.platform(device),
        "capacity": stats["capacity"],
        "route": ROUTES[args.mode],
        "signature_mb": stats["signature_bytes"] / 2**20,
        "wall_ms_per_batch": 1000 * ts[0] / args.n_batches,
        "device_ms_per_batch": device_ms,
        "launches": launches,
        "seconds": time.perf_counter() - t_run,
        "peak_device_bytes": st.peak_bytes(device),
        "device": dev_card,
    })


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--batch", type=int, default=131_072)
    ap.add_argument("--query-batch", type=int, default=8192)
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--bucket-cap", type=int, default=128)
    ap.add_argument("--mode", choices=["scan", "bucket", "hamming"], default="scan",
                    help="query engine: full scan or sorted-bucket search")
    ap.add_argument("--parquet", action="store_true",
                    help="stream via a Parquet file (exercises create_signatures)")
    ap.add_argument("--hash-mode", choices=["device", "host"], default="host",
                    help="hash on device (ships raw vectors) or host (ships "
                    "64B packed words; wins when the link is the bottleneck)")
    ap.add_argument("--smoke", action="store_true",
                    help="65,536 rows in 16,384-row batches, 1,024-query batches, 2 batches")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.parquet:
        try:
            import pyarrow.parquet  # noqa: F401
        except ImportError as exc:
            print(f"torch_scale_bench: --parquet needs pyarrow, which is not installed ({exc})",
                  file=sys.stderr)
            return 1
    device = st.resolve_device(args.device, "torch_scale_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
