"""Default-construction 1M-slot serving bench on one GPU.

The port of ``benchmarks/auto_engine_bench.py`` to ``lshrs_tpu_torch``: the
same arguments, defaults and JSON fields. A default-constructed
``LSHRS(dim=768, num_perm=256, engine="auto", hash_mode="host",
buffer_size=1 << 30)`` indexes 2**20 gaussian rows (``default_rng(0)``)
in 2**17-row ``index()`` calls (the host hash and the 32-byte dense wire),
then serves ``serving_fn(top_k=10)`` with no mode: the engine the index
resolved. Past ``LSHRS._AUTO_HAMMING_CAPACITY`` (2**19 slots) ``auto``
ranks by full-signature Hamming on the bitplanes, kernel B2, once per
batch; below it, and with ``--engine collision``, by band collisions on
kernel B1. A trial submits 8 batches of 8,192 queries to three threads
(each hashes and dispatches its batch; dispatches serialise on the store's
lock and the closure reads its ids back, ``.cpu()``).

``hamming_extra_bytes`` is ``stats()["index"]["hamming_plane_bytes"]``:
the bitplanes' bytes (one int8 per bit and slot, zero-padded to a
multiple of 32 bits), as the reference counts them. ``build_s`` ends at a
synchronize (the reference's clock stopped at the last dispatch).

Usage, from the repository root:

    python3 benchmarks/torch_auto_engine_bench.py [--n 1048576] [--dim 768]
        [--num-perm 256] [--query-batch 8192] [--n-batches 8] [--trials 3]
        [--engine auto|collision|hamming] [--hash-family gaussian|structured]
        [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``), and adds the card (``nvidia-smi`` name and power limit), the
kernel launches of the timed trials, the run's seconds, its peak device
bytes, and the card's ms a batch of the store's closure on the first
batch's dense wire held on the card (``device_ms_per_batch``, CUDA events)
beside the best trial's wall ms a batch (``wall_ms_per_batch``). Checks: every row indexed; ``ranking`` is Hamming exactly
when ``--engine hamming``, or ``auto`` at a capacity of at least
``LSHRS._AUTO_HAMMING_CAPACITY``; the probe (the first ``--query-batch``
rows) finds itself first at a rate of 1.0; served ids lie in ``[-1, n)``;
every trial serves the same ids; on the card B2 (at the symmetric key) or
B1 launched exactly once per timed batch, by the ranking, and no other
kernel. A failed check prints ``{"check_failed": ...}`` on stderr and
exits 1. ``--smoke``: 2**19 rows (the smallest capacity at which
``auto`` takes Hamming), 1,024-query batches, 2 batches, 2 trials.
``--device cpu`` runs the kernels' plain versions.
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

NUM_BANDS = 16
DATA_SEED = 0
STEP = 1 << 17
SMOKE = dict(n=1 << 19, query_batch=1024, n_batches=2, trials=2)


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.ops.hamming import plane_width

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    rng = np.random.default_rng(DATA_SEED)
    lsh = LSHRS(dim=args.dim, num_perm=args.num_perm, num_bands=NUM_BANDS,
                rows_per_band=args.num_perm // NUM_BANDS, engine=args.engine,
                hash_mode="host",  # the 32-byte dense wire
                hash_family=args.hash_family, initial_capacity=args.n, dedupe=False,
                buffer_size=1 << 30,  # bulk build: one flush per index() call
                device=device)

    t0 = time.perf_counter()
    X_keep = None
    for off in range(0, args.n, STEP):
        m = min(STEP, args.n - off)
        xb = rng.standard_normal((m, args.dim)).astype(np.float32)
        if off == 0:
            X_keep = xb[: args.query_batch].copy()
        lsh.index(np.arange(off, off + m), xb)
    st.sync(device)
    build_s = time.perf_counter() - t0
    alive = lsh.stats()["index"]["alive"]
    st.check(alive == args.n, "indexed", {"alive": alive, "n": args.n})

    serve = lsh.serving_fn(top_k=10)  # mode resolved by the engine
    stats = lsh.stats()
    ranking = stats["ranking"]
    capacity = stats["index"]["capacity"]
    hamming = args.engine == "hamming" or (
        args.engine == "auto" and capacity >= LSHRS._AUTO_HAMMING_CAPACITY)
    st.check(ranking == ("hamming" if hamming else "collision"), "ranking",
             {"ranking": ranking, "engine": args.engine, "capacity": capacity})

    raw = [rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
           for _ in range(args.n_batches)]
    st.check_ids("warm", serve(raw[0]), args.query_batch, 10, args.n)
    # self-match: indexed vectors must return themselves first
    probe = serve(X_keep)
    st.check_ids("probe", probe, args.query_batch, 10, args.n)
    self_match = float((probe[:, 0] == np.arange(args.query_batch)).mean())
    st.check(self_match == 1.0, "self_match", self_match)

    before = st.launch_counts()
    ts, first = st.repeated_trials(lambda: st.pooled_trial(serve, raw, read=np.asarray),
                                   args.trials, q=args.query_batch, k=10, n=args.n)
    launches = st.launch_delta(before) if st.counts_launches(device) else None
    calls = args.trials * args.n_batches
    if hamming:
        st.expect_launches("hamming_timed", launches, device, b2=calls,
                           b2_packing=(plane_width(args.num_perm), args.num_perm, 1))
    else:
        st.expect_launches("collision_timed", launches, device, b1=calls)
    n_q = args.n_batches * args.query_batch
    # the store's closure on the first batch's dense wire, held on the card
    store_serve = lsh._storage.snapshot_query_fn(10, wire="dense", mode=ranking)
    wire_dev = torch.from_numpy(lsh._hasher.hash_batch_dense_host(raw[0])).to(device)
    device_ms = st.device_ms_per_call(lambda: store_serve(wire_dev), device)
    index = lsh.stats()["index"]
    if answers is not None:
        state = lsh._storage.state_arrays()
        wire = lsh._hasher.hash_batch_dense_host
        answers.update(words=state["sig"], ids=state["ids"], capacity=capacity,
                       probe_wire=wire(X_keep), probe_ids=probe,
                       wire=[wire(q) for q in raw], served=first, ranking=ranking)
    st.emit({
        "metric": "default_construction_qps_1M",
        "engine": args.engine,
        "ranking": ranking,
        "n": args.n,
        "dim": args.dim,
        "num_perm": args.num_perm,
        "qps": n_q / ts[0],
        "qps_median": n_q / ts[len(ts) // 2],
        "build_s": build_s,
        "build_vectors_per_s": args.n / build_s,
        "self_match_rate": self_match,
        "hamming_extra_bytes": index["hamming_plane_bytes"],
        "platform": st.platform(device),
        "hash_family": args.hash_family,
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
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--query-batch", type=int, default=8192)
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--engine", default="auto", choices=["auto", "collision", "hamming"])
    ap.add_argument("--hash-family", default="gaussian", choices=["gaussian", "structured"],
                    help="LSH projection family (structured = FWHT rotations)")
    ap.add_argument("--smoke", action="store_true",
                    help="2**19 rows, 1,024-query batches, 2 batches, 2 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.query_batch > args.n:
        ap.error("--query-batch must not exceed --n: the probe is the first stored rows")
    device = st.resolve_device(args.device, "torch_auto_engine_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
