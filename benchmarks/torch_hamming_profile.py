"""Device-side stage breakdown of the Hamming (bitplane) query path on one GPU.

The port of ``benchmarks/hamming_profile.py`` to ``lshrs_tpu_torch``: the
same arguments and defaults (``--cap 1048576 --q 8192 --k 10 --group
64``; 16 x 16 bands, P=256, 256-d, hasher seed 42, data from
``default_rng(0)`` hashed on the host in 2**18-row slabs, the first ``Q``
stored rows as the queries) and the same row labels. The store is a
``DeviceStore(enable_hamming=True)`` holding those words; every row calls
the function the store's Hamming engine calls, on its own tensors:

  unpack qbits                         the queries' bitplanes
                                       (``DeviceStore._planes_rows``)
  gmax kernel only (planes)            kernel B2 (``hamming_group_max_keys``)
  full: unpack+kernel+select+refine    ``hamming_topk_core``, as the store
                                       runs it (the ``full`` row)
  hierarchical top-groups only         the select stage: the port's flat
                                       ``torch.topk`` (``select_top_groups``);
                                       the reference's label is kept
  select+refine tail only              ``ops.hamming._select_refine``
  gather / popcount / final top-k      the tail's other stages
                                       (``hamming_refine_gather``,
                                       ``refine_hamming``,
                                       ``hamming_final_topk``), each on the
                                       previous stage's output
  served                               the store's own
                                       ``snapshot_query_fn(mode="hamming")``
                                       closure

Not ported: ``full with optimization_barrier`` (the barrier was a TPU
workaround), and ``--q-tile``, which is accepted and ignored (B2 tiles its
queries itself). The ideal line prints the card's int8 rate and B2's bound
(``chip_smoke.py::kernel_bound``), not the reference's TPU rate.

Timing (``benchmarks/torch_stage_timing.py``): each row is warmed up, then
``N_ITER`` (8) back-to-back calls are timed with CUDA events; the median
over ``--trials`` of ms per call, with ``issue_ms`` (the host's time to
enqueue a call) and ``wall_ms`` by the host's clock.

Usage, from the repository root:

    python3 benchmarks/torch_hamming_profile.py [--cap 1048576] [--q 8192] [--k 10]
        [--group 64] [--q-tile 256] [--trials 5] [--smoke] [--device cuda|cpu]

Prints the ideal line, one JSON line per row (with the launches and the
card's name and power limit), then a ``hamming_profile_summary`` line (the
stages' ms and their sum beside ``full`` and ``served``). Checks: the
stages composed return the same distances and ids as ``full``, the tail
the same, ``served`` the same ids, every query finds its own row first at
distance 0, and on the card B2 launched exactly once a call at 256
columns in the kernel, ``full`` and ``served`` rows and never elsewhere. A
failed check prints ``{"check_failed": ...}`` on stderr and exits 1.
``--smoke``: 2**16 slots, 1,024 queries, 2 trials. ``--device cpu`` runs
the kernel's plain version.
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

from lshrs_tpu_torch.ops.group_max import hamming_group_max_keys, key_scale  # noqa: E402
from lshrs_tpu_torch.ops.hamming import (  # noqa: E402
    _select_refine,
    hamming_final_topk,
    hamming_refine_gather,
    hamming_select_terms,
    hamming_topk_core,
    plane_width,
    refine_hamming,
)
from lshrs_tpu_torch.ops.scan import select_top_groups  # noqa: E402

NUM_BANDS, ROWS_PER_BAND, DIM = 16, 16, 256
NUM_PERM = NUM_BANDS * ROWS_PER_BAND
HASH_SEED = 42
DATA_SEED = 0
SLAB = 1 << 18
N_ITER = 8
METRIC = "hamming_profile"
SMOKE = dict(cap=1 << 16, q=1024, trials=2)


def build(args, device):
    """The store holding ``--cap`` rows hashed on the host, slab by slab."""
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    hasher = LSHHasher(NUM_BANDS, ROWS_PER_BAND, DIM, seed=HASH_SEED, device=device)
    rng = np.random.default_rng(DATA_SEED)
    words = np.empty((args.cap, NUM_BANDS), np.uint32)
    for lo in range(0, args.cap, SLAB):
        hi = min(lo + SLAB, args.cap)
        words[lo:hi] = hasher.hash_batch_words_host(
            rng.standard_normal((hi - lo, DIM)).astype(np.float32))
    store = DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
                        enable_hamming=True, initial_capacity=args.cap, group_size=args.group,
                        dedupe=False, device=device)
    store.add_signature_batch(np.arange(args.cap), words)
    store._ensure_ranks()
    store._ensure_planes()
    return store, words


def ideal(args, capacity: int) -> dict:
    """B2's product at this shape against the card's int8 rate, and its
    bound as ``chip_smoke.py`` computes it."""
    from chip_smoke import H100_INT8_OPS, kernel_bound

    ops = 2 * args.q * capacity * NUM_PERM
    bound_ms, bound_by = kernel_bound(
        "hamming_group_max_keys", dict(C=capacity, Q=args.q, P=NUM_PERM, group=args.group))
    return {"metric": f"{METRIC}_ideal", "cap": args.cap, "capacity": capacity, "q": args.q,
            "P": NUM_PERM, "group": args.group, "q_tile": None, "int8_ops": ops,
            "int8_ops_per_s": H100_INT8_OPS, "int8_ideal_ms": 1000 * ops / H100_INT8_OPS,
            "b2_bound_ms": bound_ms, "b2_bound_by": bound_by}


def profile(args, device, answers) -> None:
    dev_card = st.card(device)
    store, words = build(args, device)
    st.emit({**ideal(args, store._capacity), "device": dev_card})
    qw = store._sig_rows[: args.q].contiguous()
    planes, tie, ids, sig_t = store._planes, store._tie, store._ids, store._sig_t
    rows, narrow_r, group = store._refine_rows(), store._refine_narrow_r, store._group()
    m, scale, wide = hamming_select_terms(store._capacity // group, group, p=NUM_PERM, k=args.k)
    common = dict(device=device, n_iter=N_ITER, trials=args.trials, dev_card=dev_card, q=args.q)
    b2 = {"b2": 1, "b2_width": plane_width(NUM_PERM)}

    def row(label, fn, stage=None, per_call=None):
        return st.timed_row(METRIC, label, fn, stage=stage, per_call=per_call, **common)

    unpack = row("unpack qbits", lambda: store._planes_rows(qw), "unpack")
    qbits = unpack["out"]
    kern = row("gmax kernel only (planes)", lambda: hamming_group_max_keys(
        planes, tie, qbits, group=group, scale=key_scale(store._capacity), num_perm=NUM_PERM),
        "kernel", b2)
    gmax = kern["out"]
    full = row("full: unpack+kernel+select+refine", lambda: hamming_topk_core(
        planes, tie, store._planes_rows(qw), qw, rows, k=args.k, group=group, narrow_r=narrow_r,
        num_perm=NUM_PERM, sig_t=sig_t, ids=ids), "full", b2)
    sel = row("hierarchical top-groups only", lambda: select_top_groups(gmax, m), "select")
    tail = row("select+refine tail only", lambda: _select_refine(
        gmax, qw, rows, p=NUM_PERM, k=args.k, group=group, narrow_r=narrow_r, sig_t=sig_t,
        tie=tie, ids=ids))
    gat = row("gather", lambda: hamming_refine_gather(
        qw, rows, sel["out"], group=group, narrow_r=narrow_r, sig_t=sig_t, tie=tie, ids=ids),
        "gather")
    cwords, cand_tie, cand_ids, qcmp = gat["out"]
    pop = row("popcount", lambda: refine_hamming(cwords, qcmp), "popcount")
    fin = row("final top-k", lambda: hamming_final_topk(
        pop["out"], cand_tie, cand_ids, p=NUM_PERM, k=args.k, scale=scale, wide=wide),
        "final_top_k")
    serve = store.snapshot_query_fn(args.k, mode="hamming")
    served = row("served", lambda: serve(qw), "served", b2)

    dist, got_ids = full["out"]
    st.check(st.same(fin["out"], full["out"]), "stages_equal_full", "the composed stages differ")
    st.check(st.same(tail["out"], full["out"]), "tail_equal_full", "the tail differs")
    st.check(st.same(served["out"], got_ids), "served_equal_full", "served ids != the core's")
    own = (got_ids[:, 0].cpu() == torch.arange(args.q)) & (dist[:, 0].cpu() == 0)
    st.check(bool(own.all()), "self_match", float(own.float().mean()))

    stages = {r["stage"]: r["ms"] for r in (unpack, kern, sel, gat, pop, fin)}
    st.emit({"metric": f"{METRIC}_summary", "cap": args.cap, "q": args.q, "k": args.k,
             "group": group, "capacity": store._capacity, "narrow_r": narrow_r,
             "stages_ms": stages, "stage_sum_ms": sum(stages.values()), "full_ms": full["ms"],
             "tail_ms": tail["ms"], "served_ms": served["ms"],
             "served_issue_ms": served["issue_ms"], "served_wall_ms": served["wall_ms"],
             "device": dev_card})
    if answers is not None:
        answers.update(words=words, qwords=qw.cpu().numpy(), capacity=store._capacity,
                       group=group, hamming=dist.cpu().numpy(), ids=got_ids.cpu().numpy(),
                       served=served["out"].cpu().numpy())


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap", type=int, default=1 << 20)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--q-tile", type=int, default=256, help="accepted and ignored (no TPU tile)")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--smoke", action="store_true", help="small sizes, every row kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    device = st.resolve_device(args.device, "torch_hamming_profile")
    if device is None:
        return 1
    return st.run_checked(profile, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
