"""Sharded against single-store build wall time: 8 shards on one GPU.

The port of ``benchmarks/sharded_build_bench.py`` to ``lshrs_tpu_torch``:
the same arguments, defaults and JSON fields. One stream of host-hashed
words (2**20 gaussian rows of 64 dimensions from ``default_rng(0)``, the
16 x 16 gaussian hasher with seed 42, ``hash_batch_words_host``, 131,072
rows a batch) is appended by ``add_signature_batch`` into one
``DeviceStore`` and into a ``ShardedDeviceStore`` over an 8-way mesh
(``initial_capacity=n``, ``dedupe=False`` for both), each timed to a
``torch.cuda.synchronize``. That checks that a sharded append costs
``O(batch)``, with no re-placement of what the store already holds. The
single store is built first, as in the reference, and so pays the
process's first uploads and allocations; the port adds a second single
build after the sharded one (``single_warm_build_s``, on a fresh store)
and the sharded build's ratio to it (``ratio_to_warm_single``).

The reference ran its 8 shards on 8 virtual CPU devices. Here the mesh
repeats the one card eight times (``make_mesh(8, devices=[device] * 8)``;
``make_mesh(8)`` asks for 8 cards). So each shard's part of a batch is
written in turn on the card's one stream. At the defaults each
131,072-row batch fills exactly one 2**17-row shard.

Usage, from the repository root:

    python3 benchmarks/torch_sharded_build_bench.py [--n 1048576] [--batch 131072]
        [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` names the
card's kind with its 8 shards, and ``note`` says how they run) and adds
the capacity, the launches of each stage, the card (``nvidia-smi`` name
and power limit), the run's seconds and its peak device bytes. Checks: on
the card no kernel launches during any build; no store's capacity
changes while it is built (no growth and no re-split ran inside the
clock); every store holds ``n`` rows; the first two answer ``query_topk`` of the
first 4 stored rows' words at depth 5 with equal ids and counts, with B1
launched once on the single store and once per shard. A failed check
prints ``{"check_failed": ...}`` on stderr and exits 1. ``--smoke``:
65,536 rows (8 shards of 8,192) in 8,192-row batches. ``--device cpu``
runs the kernel's plain version, the mesh repeating the CPU.
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

B, R, D = 16, 16, 64
SHARDS = 8
DATA_SEED = 0
HASH_SEED = 42
SPOT_QUERIES, SPOT_K = 4, 5
SMOKE = dict(n=1 << 16, batch=1 << 13)


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher
    from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    h = LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=HASH_SEED, device=device)
    rng = np.random.default_rng(DATA_SEED)
    batches = []
    for start in range(0, args.n, args.batch):
        m = min(args.batch, args.n - start)
        X = rng.standard_normal((m, D)).astype(np.float32)
        batches.append((np.arange(start, start + m), h.hash_batch_words_host(X)))

    launches = {}

    def build(name, store) -> float:
        cap = store._capacity
        before = st.launch_counts()
        st.sync(device)
        t0 = time.perf_counter()
        for ids, words in batches:
            store.add_signature_batch(ids, words)
        st.sync(device)
        dt = time.perf_counter() - t0
        launches[name] = st.launch_delta(before) if st.counts_launches(device) else None
        st.expect_launches(name, launches[name], device)
        st.check(store._capacity == cap, f"{name}_capacity",
                 {"before": cap, "after": store._capacity})
        st.check(len(store) == args.n, f"{name}_count", {"want": args.n, "got": len(store)})
        return dt

    kw = dict(num_bands=B, rows_per_band=R, initial_capacity=args.n, dedupe=False)
    single = DeviceStore(device=device, **kw)
    t_single = build("single_build", single)
    sharded = ShardedDeviceStore(mesh=make_mesh(SHARDS, devices=[device] * SHARDS), **kw)
    t_sharded = build("sharded_build", sharded)
    # The single build ran first and paid the process's first uploads and
    # allocations; a second one, on a store of its own, runs warm.
    t_single_warm = build("single_warm_build", DeviceStore(device=device, **kw))

    # correctness spot check
    qw = batches[0][1][:SPOT_QUERIES]
    answers_of = {}
    for name, store, b1 in (("single_spot", single, 1), ("sharded_spot", sharded, SHARDS)):
        before = st.launch_counts()
        answers_of[name] = store.query_topk(qw, SPOT_K)
        launches[name] = st.launch_delta(before) if st.counts_launches(device) else None
        st.expect_launches(name, launches[name], device, b1=b1)
        st.check_ids(name, answers_of[name][1], SPOT_QUERIES, SPOT_K, args.n)
    (c1, i1), (c8, i8) = answers_of["single_spot"], answers_of["sharded_spot"]
    st.check(np.array_equal(i1, i8) and np.array_equal(c1, c8), "spot_check",
             {"single": i1.tolist(), "sharded": i8.tolist()})
    if answers is not None:
        answers.update(words=np.concatenate([w for _, w in batches]), qwords=qw, ids=i8,
                       counts=c8, single_ids=i1, capacity=sharded._capacity)
    kind = "gpu" if device.type == "cuda" else "cpu"
    st.emit({
        "n": args.n,
        "single_build_s": t_single,
        "sharded8_build_s": t_sharded,
        "ratio": t_sharded / t_single,
        "platform": f"{kind}-1dev-{SHARDS}shards",
        "note": f"the {SHARDS} shards of the mesh all sit on one {kind} device, so each "
                "shard's part of a batch is written in turn on one stream; at the defaults "
                "each batch fills exactly one shard (each append is O(batch))",
        "single_warm_build_s": t_single_warm,
        "ratio_to_warm_single": t_sharded / t_single_warm,
        "batch": args.batch,
        "capacity": {"single": single._capacity, "sharded": sharded._capacity,
                     "rows_per_shard": sharded._capacity // SHARDS},
        "launches": launches,
        "seconds": time.perf_counter() - t_run,
        "peak_device_bytes": st.peak_bytes(device),
        "device": dev_card,
    })


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=131_072)
    ap.add_argument("--smoke", action="store_true",
                    help="65,536 rows (8 shards of 8,192) in 8,192-row batches")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.n < SPOT_QUERIES:
        ap.error(f"--n must be at least {SPOT_QUERIES}: the spot check queries stored rows")
    device = st.resolve_device(args.device, "torch_sharded_build_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
