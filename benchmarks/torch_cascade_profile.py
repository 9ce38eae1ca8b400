"""Stage-by-stage device profile of the Hamming refinement cascade on one GPU.

The port of ``benchmarks/cascade_profile.py`` to ``lshrs_tpu_torch``: the
same arguments and defaults (``--slots 4194304 --q 8192 --cascade 64
--refine 8192 --trials 3``), the same stages and the same report keys.
The store is a ``DeviceStore(hamming_cascade=..., hamming_cascade_refine=
...)`` built with the fused hash + append (``add_vectors_batch``) from
gaussian rows drawn on the card per ``(seed, offset)`` in 2**19-row
chunks, as ``benchmarks/torch_capacity_bench.py`` draws them; the queries
are ``default_rng(123)`` draws hashed on the card. Every stage calls the
function ``hamming_topk_cascade_core`` calls, on the store's own tensors:

  unpack     the queries' prefix bitplanes (``DeviceStore._planes_rows``)
  coarse     kernel B2 over the prefix planes at the coarse key
             (``cascade_coarse_keys``)
  select     the top refine groups (``select_top_groups``: exact)
  gather     one wide refine-table row per pooled group
             (``hamming_refine_gather``)
  popcount   the full-width popcount of the pool (``refine_hamming``)
  topk       the refine keys (int64 past the ceiling) and the final top-k
             (``hamming_final_topk``)
  full       ``hamming_topk_cascade_core`` itself (``full_cascade_ms``)
  served     the store's ``snapshot_query_fn(mode="hamming")`` closure

The store serves a batch in query slices (``cascade_slice_queries``: 4
at the defaults); every stage and ``full`` is timed over the same slices,
summed, so ``full`` and ``served`` compare like with like, and the report
gives ``slices``. ``full`` takes the slices' prefix bits precomputed, as
the reference's does; ``served`` unpacks them itself (``unpack_ms``).

``--exact-select`` and ``pool_set_recall_vs_exact`` compared the
reference's approximate pool selector with the exact one. The port's pool
is always selected exactly, so ``select_exact_ms`` is ``select_ms`` and
``pool_set_recall_vs_exact`` is 1.0 by construction.

Timing (``benchmarks/torch_stage_timing.py``): each stage is warmed up,
then ``N_ITER`` (8) back-to-back calls are timed with CUDA events; the
median over ``--trials`` of ms per call, with ``issue_ms`` (the host's
time to enqueue a call) and ``wall_ms`` by the host's clock.

Usage, from the repository root:

    python3 benchmarks/torch_cascade_profile.py [--slots 4194304] [--q 8192]
        [--cascade 64] [--refine 8192] [--trials 3] [--exact-select]
        [--smoke] [--device cuda|cpu]

Prints one JSON line per stage (with its launches and the card's name and
power limit), then the report line. Checks: the stages composed return the
same distances and ids as ``full`` on every slice, ``served`` the same ids
as ``full``, and on the card B2 launched exactly once a slice at the
prefix's width in the coarse, ``full`` and ``served`` rows and never
elsewhere. A failed check prints ``{"check_failed": ...}`` on stderr and
exits 1. ``--smoke``: 2**16 slots, 1,024 queries, 2 trials. ``--device
cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_stage_timing as st  # noqa: E402

from lshrs_tpu_torch.ops.group_max import key_scale  # noqa: E402
from lshrs_tpu_torch.ops.hamming import (  # noqa: E402
    cascade_coarse_keys,
    cascade_coarse_scale,
    cascade_slice_queries,
    hamming_final_topk,
    hamming_refine_gather,
    hamming_select_terms,
    hamming_topk_cascade_core,
    refine_hamming,
)
from lshrs_tpu_torch.ops.scan import select_top_groups  # noqa: E402

NUM_BANDS, ROWS_PER_BAND, DIM, TOP_K = 16, 16, 768, 10
NUM_PERM = NUM_BANDS * ROWS_PER_BAND
HASH_SEED = 42
DATA_SEED = 7
QUERY_SEED = 123
CHUNK = 1 << 19
N_ITER = 8
METRIC = "cascade_profile"
SMOKE = dict(slots=1 << 16, q=1024, trials=2)


def build(args, device):
    """The cascade store over ``--slots`` rows drawn on the device, and the
    hashed queries."""
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    hasher = LSHHasher(NUM_BANDS, ROWS_PER_BAND, DIM, seed=HASH_SEED, device=device)
    store = DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
                        enable_hamming=True, hamming_cascade=args.cascade,
                        hamming_cascade_refine=args.refine, initial_capacity=args.slots,
                        dedupe=False, device=device)
    proj = hasher.device_projection()
    for off in range(0, args.slots, CHUNK):
        n = min(CHUNK, args.slots - off)
        store.add_vectors_batch(np.arange(off, off + n),
                                st.draw_rows(DATA_SEED, off, n, DIM, device), proj)
    store._ensure_ranks()
    store._ensure_planes()
    rng = np.random.default_rng(QUERY_SEED)
    qw = hasher.hash_batch_words(rng.standard_normal((args.q, DIM)).astype(np.float32))
    return store, qw


def profile(args, device, answers) -> None:
    dev_card = st.card(device)
    store, qw = build(args, device)
    planes, tie, ids, sig_t = store._planes, store._tie, store._ids, store._sig_t
    rows, narrow_r, group, cap = (store._refine_rows(), store._refine_narrow_r, store._group(),
                                  store._capacity)
    refine_groups = store._cascade_groups(TOP_K)
    m, scale, wide = hamming_select_terms(cap // group, group, p=NUM_PERM, k=TOP_K,
                                          m_groups=refine_groups)
    nw = rows.shape[1] // group - 2
    step = cascade_slice_queries(cap, group=group, pool_groups=min(refine_groups, cap // group),
                                 words=nw)
    spans = [(s, min(s + step, args.q)) for s in range(0, args.q, step)]
    qws = [qw[s:e] for s, e in spans]
    common = dict(device=device, n_iter=N_ITER, trials=args.trials, dev_card=dev_card, q=args.q,
                  slices=len(spans))
    b2 = {"b2": len(spans), "b2_width": args.cascade}

    def row(stage, fn, per_call=None):
        return st.timed_row(METRIC, stage, fn, stage=stage, per_call=per_call, **common)

    def each(fn, *parts):
        return [fn(*p) for p in zip(*parts)]

    unpack = row("unpack", lambda: each(store._planes_rows, qws))
    qbits = unpack["out"]
    coarse = row("coarse", lambda: each(
        lambda qb: cascade_coarse_keys(planes, tie, qb, group=group), qbits), b2)
    sel = row("select", lambda: each(lambda g: select_top_groups(g, m), coarse["out"]))
    gat = row("gather", lambda: each(lambda q, tg: hamming_refine_gather(
        q, rows, tg, group=group, narrow_r=narrow_r, sig_t=sig_t, tie=tie, ids=ids),
        qws, sel["out"]))
    pop = row("popcount", lambda: each(lambda g: refine_hamming(g[0], g[3]), gat["out"]))
    fin = row("topk", lambda: each(lambda h, g: hamming_final_topk(
        h, g[1], g[2], p=NUM_PERM, k=TOP_K, scale=scale, wide=wide), pop["out"], gat["out"]))
    full = row("full", lambda: each(lambda qb, q: hamming_topk_cascade_core(
        planes, tie, qb, q, rows, num_perm=NUM_PERM, k=TOP_K, refine_groups=refine_groups,
        group=group, narrow_r=narrow_r, sig_t=sig_t, ids=ids), qbits, qws), b2)
    serve = store.snapshot_query_fn(TOP_K, mode="hamming")
    served = row("served", lambda: serve(qw), b2)

    for i, (got, want) in enumerate(zip(fin["out"], full["out"])):
        st.check(st.same(got, want), "stages_equal_full", f"slice {i}")
    full_ids = torch.cat([i for _, i in full["out"]])
    st.check(st.same(served["out"], full_ids), "served_equal_full", "served ids != the core's")
    dist = torch.cat([h for h, _ in full["out"]])
    st.check(bool(((dist >= 0) & (dist <= NUM_PERM + 1)).all()), "distance_range", "out of [0, P+1]")

    stages = {s["stage"]: s["ms"] for s in (coarse, sel, gat, pop, fin)}
    report = {
        "slots": args.slots, "capacity": cap, "q": args.q, "cascade": args.cascade,
        "refine": args.refine, "refine_groups": refine_groups, "group": group,
        "tie_shift": cascade_coarse_scale(args.cascade, cap)[1], "key_scale": key_scale(cap),
        "slices": len(spans), "unpack_ms": unpack["ms"],
        **{f"{k}_ms": v for k, v in stages.items() if k in ("coarse", "select")},
    }
    if args.exact_select:
        report.update(select_exact_ms=sel["ms"], pool_set_recall_vs_exact=1.0,
                      pool_selection="exact: the port selects the pool with torch.topk")
    report.update(narrow_r=narrow_r, refine_words_per_slot=nw, gather_ms=gat["ms"],
                  popcount_ms=pop["ms"], topk_ms=fin["ms"], full_cascade_ms=full["ms"],
                  stage_sum_ms=sum(stages.values()), served_ms=served["ms"],
                  served_issue_ms=served["issue_ms"], served_wall_ms=served["wall_ms"],
                  device=dev_card)
    st.emit(report)
    if answers is not None:
        answers.update(words=store.state_arrays()["sig"], qwords=qw.cpu().numpy(),
                       capacity=cap, group=group, refine_groups=refine_groups,
                       hamming=dist.cpu().numpy(), ids=full_ids.cpu().numpy(),
                       served=served["out"].cpu().numpy())


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=1 << 22)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--cascade", type=int, default=64)
    ap.add_argument("--refine", type=int, default=8192)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--exact-select", action="store_true",
                    help="report the exact pool selector (the port's only one)")
    ap.add_argument("--smoke", action="store_true", help="small sizes, every stage kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    device = st.resolve_device(args.device, "torch_cascade_profile")
    if device is None:
        return 1
    return st.run_checked(profile, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
