"""Top-p rerank benchmark on one GPU (BASELINE config #2): batched get_above_p.

The port of ``benchmarks/rerank_bench.py`` to ``lshrs_tpu_torch``: the same
arguments, defaults and JSON fields. 100,000 gaussian rows of 768
dimensions (``default_rng(0)``) are indexed with their payload on the card
(``store_vectors=True``, 16 x 16 bands, the capacity the next power of two
and at least 2**14: 131,072). ``get_above_p_batch(p=0.2, top_k=10)`` of
the first ``--query-batch`` stored rows is the probe (each must rank
itself first). Then the pipelined loop: a hasher thread makes each
batch's dense wire (``hash_batch_dense_host``) and its query vectors
(float32, or a ``torch.bfloat16`` tensor with ``--wire-dtype bfloat16``:
the reference cast with ``ml_dtypes.bfloat16``, round-to-nearest-even as
torch's cast), this thread dispatches ``snapshot_topp_fn(10,
wire="dense")``, a reader thread reads ids, cosines and candidate counts
back (``.cpu()``, the completion barrier).

The closure resolves ``rerank_engine="auto"`` once, for its default
1,024-query batch hint; the row prints what it resolved
(``rerank_engine``). At the defaults that is the full engine: band counts
and one float32 GEMM in plain torch, no kernel. The gather engine runs
kernel B1 once per query slice.

Usage, from the repository root:

    python3 benchmarks/torch_rerank_bench.py [--n 100000] [--dim 768] [--num-perm 256]
        [--p 0.2] [--top-k 10] [--query-batch 1024] [--n-batches 8] [--trials 3]
        [--wire-dtype float32|bfloat16] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``), and adds the resolved engine, the card (``nvidia-smi`` name and
power limit), the kernel launches of the timed trials, the run's seconds,
its peak device bytes, and the card's ms a batch on the first batch's
wire and vectors held on the card (``device_ms_per_batch``, CUDA events;
``latency_ms_per_batch`` is the wall clock's). Checks: the probe's self-match is 1.0, served
ids lie in ``[-1, n)``, every trial serves the same ids, and on the card
the full engine launched no kernel and the gather engine B1 exactly once
per query slice of each timed batch. A failed check prints
``{"check_failed": ...}`` on stderr and exits 1. ``--smoke``: 16,384
rows, 256-query batches, 2 batches, 2 trials. ``--device cpu`` runs the
plain versions.
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
SMOKE = dict(n=1 << 14, query_batch=256, n_batches=2, trials=2)


def read_all(out) -> tuple:
    return tuple(st.to_host(x) for x in out)


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import LSHRS

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    rng = np.random.default_rng(DATA_SEED)
    lsh = LSHRS(dim=args.dim, num_perm=args.num_perm, num_bands=NUM_BANDS,
                rows_per_band=args.num_perm // NUM_BANDS, backend="device", store_vectors=True,
                initial_capacity=1 << max(14, (args.n - 1).bit_length()), dedupe=False,
                device=device)
    X = rng.standard_normal((args.n, args.dim)).astype(np.float32)
    lsh.index(np.arange(args.n), X)

    raw = [rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
           for _ in range(args.n_batches)]
    # correctness probe: self-queries rerank themselves first
    probe = lsh.get_above_p_batch(X[: args.query_batch], p=args.p, top_k=args.top_k,
                                  wire_dtype=args.wire_dtype)
    self_match = float(np.mean([r[0][0] == i for i, r in enumerate(probe) if r]))
    st.check(self_match == 1.0 and all(probe), "self_match", self_match)

    store, hasher = lsh._storage, lsh._hasher
    serve = store.snapshot_topp_fn(args.top_k, wire="dense")
    # snapshot_topp_fn's default batch hint is _resolve_rerank_engine's default q.
    engine, max_candidates = store._resolve_rerank_engine(None, None)
    bf16 = args.wire_dtype == "bfloat16"

    def prep(q):
        return hasher.hash_batch_dense_host(q), torch.from_numpy(q).to(torch.bfloat16) if bf16 else q

    def dispatch(prepared):
        return serve(*prepared)

    warm = read_all(dispatch(prep(raw[0])))
    st.check_ids("warm", warm[0], args.query_batch, args.top_k, args.n)

    before = st.launch_counts()
    ts, first = st.repeated_trials(lambda: st.pipelined_trial(prep, dispatch, read_all, raw),
                                   args.trials, q=args.query_batch, k=args.top_k, n=args.n,
                                   ids_of=lambda out: out[0])
    launches = st.launch_delta(before) if st.counts_launches(device) else None
    calls = args.trials * args.n_batches
    slices = -(-args.query_batch // store._topp_dev_batch(engine, max_candidates))
    st.expect_launches(f"{engine}_timed", launches, device,
                       b1=calls * slices if engine == "gather" else 0)
    elapsed = ts[0]
    n_q = args.n_batches * args.query_batch
    on_card = [torch.as_tensor(x).to(device) for x in prep(raw[0])]
    device_ms = st.device_ms_per_call(lambda: serve(*on_card), device)
    if answers is not None:
        state = store.state_arrays()
        answers.update(words=state["sig"], ids=state["ids"], payload=state["payload"],
                       capacity=store._capacity, probe_x=X[: args.query_batch],
                       probe_words=st.to_host(hasher.hash_batch_words(X[: args.query_batch])),
                       probe=probe, raw=raw, wire=[prep(q)[0] for q in raw], served=first,
                       engine=engine)
    st.emit({
        "metric": "rerank_topp_qps_pipelined",
        "wire_dtype": args.wire_dtype,
        "n": args.n,
        "dim": args.dim,
        "p": args.p,
        "top_k": args.top_k,
        "query_batch": args.query_batch,
        "qps": n_q / elapsed,
        "latency_ms_per_batch": 1000 * elapsed / args.n_batches,
        "self_match_rate": self_match,
        "platform": st.platform(device),
        "rerank_engine": engine,
        "device_ms_per_batch": device_ms,
        "launches": launches,
        "seconds": time.perf_counter() - t_run,
        "peak_device_bytes": st.peak_bytes(device),
        "device": dev_card,
    })


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--p", type=float, default=0.2)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--query-batch", type=int, default=1024)
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--wire-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="query upload dtype (bfloat16 halves the bytes)")
    ap.add_argument("--smoke", action="store_true",
                    help="16,384 rows, 256-query batches, 2 batches, 2 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.query_batch > args.n:
        ap.error("--query-batch must not exceed --n: the probe is the first stored rows")
    device = st.resolve_device(args.device, "torch_rerank_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
