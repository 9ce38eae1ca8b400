"""End-to-end asymmetric-ranking serving throughput (pipelined) on one GPU.

The port of ``benchmarks/asymmetric_bench.py`` to ``lshrs_tpu_torch``: the
same arguments, defaults and JSON fields. 2**20 gaussian rows of 256
dimensions (``default_rng(11)``) are hashed on the host (16 x 16 bands,
hasher seed 42) and appended as the dense wire to a ``DeviceStore`` with
bitplanes (``enable_hamming=True``, ``chunk_size=2048``, ``dedupe=False``).
Queries ship their quantised projection coordinates
(``quantize_coords_np(hasher.hash_batch_coords_host(q))``: ``num_perm``
int8 bytes a query, 8x the 32-byte dense wire) to
``snapshot_query_fn(10, mode="asymmetric")``, which ranks them on kernel
B2 at the int8 wire's key packing (offset ``P x 127`` = 32,512, shift 5
at 2**20 slots) and re-ranks the top groups exactly. A trial runs the
reference's pipeline: a hasher thread -> one dispatch per batch on this
thread -> a reader thread that reads the ids back (``.cpu()``, the
completion barrier).

Usage, from the repository root:

    python3 benchmarks/torch_asymmetric_bench.py [--n 1048576] [--dim 256]
        [--num-perm 256] [--bands 16] [--query-batch 16384] [--n-batches 6]
        [--trials 5] [--top-k 10] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``), and adds the card (``nvidia-smi`` name and power limit), the
kernel launches of the timed trials, the run's seconds, its peak device
bytes, and the card's ms a batch on the first batch's coordinates held on
the card (``device_ms_per_batch``, CUDA events) beside the best trial's
wall ms a batch (``wall_ms_per_batch``). ``build_s`` ends at a synchronize (the reference's clock
stopped when the append was dispatched). Checks: the probe (the first
``--query-batch`` stored rows) finds itself first at a rate of 1.0, every
served id lies in ``[-1, n)``, every trial serves the same ids, and on the
card B2 launched exactly once per timed batch, at that packing, and no
other kernel. A failed check prints ``{"check_failed": ...}`` on stderr
and exits 1. ``--smoke`` keeps the 2**20 rows (the packing's shift is set
by the capacity) and cuts the batches: 1,024 queries, 2 batches, 2
trials. ``--device cpu`` runs the kernel's plain version.
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

DATA_SEED = 11
HASH_SEED = 42
SMOKE = dict(query_batch=1024, n_batches=2, trials=2)


def int8_packing(num_perm: int, capacity: int) -> tuple[int, int, int]:
    """B2's key packing ``(operand width, offset, shift)`` on the int8 wire."""
    from lshrs_tpu_torch.ops.asymmetric import QMAX
    from lshrs_tpu_torch.ops.group_max import asymmetric_shift
    from lshrs_tpu_torch.ops.hamming import plane_width

    return plane_width(num_perm), num_perm * QMAX, asymmetric_shift(num_perm, capacity)


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher
    from lshrs_tpu_torch.ops.asymmetric import quantize_coords_np

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    rows = args.num_perm // args.bands
    rng = np.random.default_rng(DATA_SEED)
    hasher = LSHHasher(num_bands=args.bands, rows_per_band=rows, dim=args.dim, seed=HASH_SEED,
                       device=device)
    store = DeviceStore(num_bands=args.bands, rows_per_band=rows, chunk_size=2048,
                        initial_capacity=args.n, enable_hamming=True, dedupe=False, device=device)

    X = rng.standard_normal((args.n, args.dim)).astype(np.float32)
    t0 = time.perf_counter()
    store.add_signature_batch(np.arange(args.n), hasher.hash_batch_dense_host(X))
    st.sync(device)
    build_s = time.perf_counter() - t0

    def hash_asym(q: np.ndarray) -> np.ndarray:
        qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(q))
        return qi8

    serve = store.snapshot_query_fn(args.top_k, mode="asymmetric")
    raw = [rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
           for _ in range(args.n_batches)]
    # warm the closure and check self-match through the same path
    probe_coords = hash_asym(X[: args.query_batch])
    probe = st.to_host(serve(probe_coords))
    st.check_ids("probe", probe, args.query_batch, args.top_k, args.n)
    self_match = float((probe[:, 0] == np.arange(args.query_batch)).mean())
    st.check(self_match == 1.0, "self_match", self_match)

    before = st.launch_counts()
    ts, first = st.repeated_trials(lambda: st.pipelined_trial(hash_asym, serve, st.to_host, raw),
                                   args.trials, q=args.query_batch, k=args.top_k, n=args.n)
    launches = st.launch_delta(before) if st.counts_launches(device) else None
    calls = args.trials * args.n_batches
    st.expect_launches("timed", launches, device, b2=calls,
                       b2_packing=int8_packing(args.num_perm, store._capacity))
    nq = args.n_batches * args.query_batch
    coords_dev = torch.from_numpy(hash_asym(raw[0])).to(device)
    device_ms = st.device_ms_per_call(lambda: serve(coords_dev), device)
    if answers is not None:
        answers.update(words=store.state_arrays()["sig"], capacity=store._capacity,
                       probe_coords=probe_coords, probe_ids=probe,
                       coords=[hash_asym(q) for q in raw], ids=first)
    st.emit({
        "metric": f"asymmetric_qps_{args.n}x{args.dim}d_top{args.top_k}",
        "qps_best": nq / ts[0],
        "qps_median": nq / ts[len(ts) // 2],
        "self_match_rate": self_match,
        "wire_bytes_per_query": args.num_perm,
        "build_s": build_s,
        "query_batch": args.query_batch,
        "pipeline": "hash-thread/dispatch/reader-thread",
        "platform": st.platform(device),
        "b2_packing": list(int8_packing(args.num_perm, store._capacity)),
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
    ap.add_argument("--bands", type=int, default=16)
    ap.add_argument("--query-batch", type=int, default=16384)
    ap.add_argument("--n-batches", type=int, default=6)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="2**20 rows kept, 1,024-query batches, 2 batches, 2 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.query_batch > args.n:
        ap.error("--query-batch must not exceed --n: the probe is the first stored rows")
    device = st.resolve_device(args.device, "torch_asymmetric_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
