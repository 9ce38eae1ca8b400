"""In-place retune on one GPU: `DeviceStore.rehash` against the initial fused build.

The port of ``benchmarks/rehash_bench.py`` to ``lshrs_tpu_torch``: the
same arguments, defaults and JSON fields. 2**20 gaussian rows of 256
dimensions (``default_rng(0)``) are uploaded once and built into a
``DeviceStore`` with the rows kept as its payload (``store_vectors=True``,
``--payload-dtype``, ``dedupe=False``, ``chunk_size=2048``, capacity
``next_pow2(n)``) by one fused ``add_vectors_batch`` under the 16 x 16
gaussian hasher (seed 1). Then ``--trials`` in-place rehashes alternate the
32 x 8 hasher (seed 2) and the 16 x 16 one, so an odd count ends at 32 x 8:
each rebuilds every stored signature from the payload on the card
(``DeviceStore.rehash``, a float32 matmul with TF32 off and a bitpack per
block of slots). Last, 1,024 of the stored rows, hashed on the card under
the final hasher, query ``query_topk(words, 1)`` (kernel B1) and the share
that finds itself first is ``self_match``.

One field the reference lacks, the port's addition: ``rebuild_after_rehash``
times that self-match query twice (``first_query_s``, ``repeat_query_s``),
then rehashes once more to the same hasher and times it twice again
(``warm_first_query_s``, ``warm_repeat_query_s``). A rehash drops the
refine table and the tie keys (rebuilt lazily), so the first query after a
retune pays that rebuild and the second does not; the first pair also pays
the process's first query (each kernel's first launch), so ``rebuild_s``
is the difference of the warm pair.

Usage, from the repository root:

    python3 benchmarks/torch_rehash_bench.py [--n 1048576] [--dim 256] [--num-perm 256]
        [--trials 5] [--payload-dtype float32|bfloat16|int8] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``) and adds the banding served, the card (``nvidia-smi`` name and
power limit), the launches of each timed stage, the run's seconds and its
peak device bytes, also apart for the build (which hashes every row in one
call) and for the rehash trials (the payload, the old signature rows and
the new ones live together during the swap), and each trial's seconds in
trial order. Clocks stop at a ``torch.cuda.synchronize`` (the reference's
at a read of a few stored values); the self-match clocks include the read
of the ids. Checks: on the card no kernel launches during the build or a
rehash, and B1 exactly once per self-match query; every query serves the
same ids, each in ``[-1, n)``; at ``float32`` the
self-match is 1.0 (a rehash of a float32 payload equals a fresh build). An
int8 payload hashes its raw integers and a bfloat16 one its rounded rows
while the queries hash float32 rows, so there the self-match is recorded,
not checked. A failed check prints ``{"check_failed": ...}`` on stderr and
exits 1. ``--smoke``: 65,536 rows, 3 trials. ``--device cpu`` runs the
kernel's plain version.
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
OLD_SEED, NEW_SEED = 1, 2
SELF_QUERIES = 1024
SMOKE = dict(n=1 << 16, trials=3)


def timed(device, fn) -> float:
    """Seconds of ``fn()`` to a synchronize after it."""
    st.sync(device)
    t0 = time.perf_counter()
    fn()
    st.sync(device)
    return time.perf_counter() - t0


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    nb, r = 16, args.num_perm // 16
    X = np.random.default_rng(DATA_SEED).standard_normal((args.n, args.dim)).astype(np.float32)
    X_dev = torch.from_numpy(X).to(device)

    h_old = LSHHasher(num_bands=nb, rows_per_band=r, dim=args.dim, seed=OLD_SEED, device=device)
    h_new = LSHHasher(num_bands=nb * 2, rows_per_band=r // 2, dim=args.dim, seed=NEW_SEED,
                      device=device)
    store = DeviceStore(
        num_bands=nb, rows_per_band=r, dim=args.dim, store_vectors=True,
        payload_dtype=args.payload_dtype, dedupe=False,
        initial_capacity=1 << (args.n - 1).bit_length(), chunk_size=2048, device=device,
    )
    before = st.launch_counts()
    build_s = timed(device, lambda: store.add_vectors_batch(
        np.arange(args.n), X_dev, h_old.device_projection()))
    launches = {"build": st.launch_delta(before) if st.counts_launches(device) else None}
    st.expect_launches("build", launches["build"], device)

    hashers = [h_old, h_new]

    def rehash(h) -> float:
        return timed(device, lambda: store.rehash(
            h.device_projection(), num_bands=h.num_bands, rows_per_band=h.rows_per_band))

    build_peak = st.peak_bytes(device)
    st.reset_peak(device)
    before = st.launch_counts()
    trial_s = [rehash(hashers[(t + 1) % 2]) for t in range(args.trials)]
    trials = sorted(trial_s)
    launches["rehash"] = st.launch_delta(before) if st.counts_launches(device) else None
    st.expect_launches("rehash", launches["rehash"], device)
    rehash_peak = st.peak_bytes(device)

    # The self-match probe under the final hasher, twice; then once more
    # after one more rehash to the same hasher: the first pair also pays
    # the process's first query, the second only what the rehash dropped.
    h = hashers[args.trials % 2]
    qw = h.hash_batch_words(X_dev[:SELF_QUERIES])
    queries = {}

    def query(name) -> None:
        before = st.launch_counts()
        t0 = time.perf_counter()
        _, ids = store.query_topk(qw, 1)
        queries[name] = (time.perf_counter() - t0, ids)
        launches[name] = st.launch_delta(before) if st.counts_launches(device) else None
        st.expect_launches(name, launches[name], device, b1=1)
        st.check_ids(name, ids, SELF_QUERIES, 1, args.n)

    query("first_query")
    query("repeat_query")
    before = st.launch_counts()
    rehash(h)
    launches["warm_rehash"] = st.launch_delta(before) if st.counts_launches(device) else None
    st.expect_launches("warm_rehash", launches["warm_rehash"], device)
    query("warm_first_query")
    query("warm_repeat_query")
    ids = queries["first_query"][1]
    st.check(all(np.array_equal(ids, q[1]) for q in queries.values()), "repeat_query_ids",
             "a repeated query served other ids")
    seconds = {name: q[0] for name, q in queries.items()}
    self_match = float((ids[:, 0] == np.arange(SELF_QUERIES)).mean())
    if args.payload_dtype == "float32":
        st.check(self_match == 1.0, "self_match", self_match)
    if answers is not None:
        answers.update(words=store.state_arrays()["sig"], qwords=st.to_host(qw), ids=ids,
                       bands=(store.num_bands, store.rows_per_band))
    st.emit({
        "n": args.n,
        "dim": args.dim,
        "payload_dtype": args.payload_dtype,
        "initial_build_s": build_s,
        "rehash_s_best": trials[0],
        "rehash_s_median": trials[len(trials) // 2],
        "rehash_rows_per_s": args.n / trials[0],
        "self_match": self_match,
        "platform": st.platform(device),
        "banding": f"{store.num_bands}x{store.rows_per_band}",
        "rehash_s": trial_s,  # in trial order: 32 x 8 first, then alternating
        "rebuild_after_rehash": {
            **{f"{name}_s": s for name, s in seconds.items()},
            "rebuild_s": seconds["warm_first_query"] - seconds["warm_repeat_query"],
            "queries": SELF_QUERIES,
        },
        "launches": launches,
        "seconds": time.perf_counter() - t_run,
        "peak_device_bytes": max(build_peak, rehash_peak) if build_peak is not None else None,
        "build_peak_device_bytes": build_peak,
        "rehash_peak_device_bytes": rehash_peak,
        "device": dev_card,
    })


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--payload-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--smoke", action="store_true", help="65,536 rows, 3 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.n < SELF_QUERIES:
        ap.error(f"--n must be at least {SELF_QUERIES}: the self-match queries are stored rows")
    if args.trials < 1 or args.num_perm % 32:
        ap.error("--trials must be positive and --num-perm a multiple of 32 (16 x r and 32 x r/2)")
    device = st.resolve_device(args.device, "torch_rehash_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
