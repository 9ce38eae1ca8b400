"""Device-side stage breakdown of the grouped collision query on one GPU.

The port of ``benchmarks/kernel_profile.py`` to ``lshrs_tpu_torch``: the
same arguments and defaults (``--cap 131072 --q 1024 --k 10 --group 32``;
16 x 16 bands, 768-d, hasher seed 42, data from ``default_rng(0)``, the
first ``Q`` stored rows as the queries) and the same row labels. The
store is a ``DeviceStore`` holding the words at ``--cap`` slots; every
row calls the function its core calls on the store's own tensors (the
transposed words, tie keys, ids and grouped refine table):

  gmax kernel only          kernel B1 (``group_max_keys``)
  kernel+select+refine      ``collision_topk_grouped_core``, ``sig_rows=None``
                            (the per-slot gather)
  kernel+select+row-refine  the same core with the store's grouped refine
                            table: the ``full`` row, as the store runs it
  kernel+topk               B1 and one ``torch.topk`` (the port's
                            counterpart of the reference's ``kernel+lax.top_k``)
  device hash Q=...         the queries' device hash
  select / gather / recount / final top-k
                            the core's stages alone (``select_top_groups``,
                            ``gather_refine``, ``refine_counts_vs_query``,
                            ``collision_final_topk``), each on the previous
                            stage's output computed before it is timed
  served                    the store's own ``snapshot_query_fn`` closure,
                            by CUDA events and by the host's clock

The reference's ``kernel+approx_max_k`` row is not ported: the port has no
approximate selector (the cascade selects its pool exactly, as every
engine does).

Timing (``benchmarks/torch_stage_timing.py``): each row is warmed up, then
``N_ITER`` (16) back-to-back calls are timed with CUDA events; the row
reports the median over ``--trials`` of ms per call, with ``issue_ms``
(the host's time to enqueue a call) and ``wall_ms`` by the host's clock. The reference timed a data-dependent ``fori_loop``
instead, a workaround for its remote tunnel.

Usage, from the repository root:

    python3 benchmarks/torch_kernel_profile.py [--cap 131072] [--q 1024] [--k 10]
        [--group 32] [--trials 5] [--smoke] [--device cuda|cpu]

Prints one JSON line per row (label, stage, ms, issue_ms, wall_ms, qps, the kernel
launches of the row, the card's name and power limit), then a
``kernel_profile_summary`` line: the stages' ms, their sum beside the
``full`` and ``served`` rows. Checks: the stage-by-stage composition
returns the same counts and ids as ``full``, the per-slot refine the same
as ``full``, ``served`` the same ids as ``full``, every query finds its
own row first, and on the card each row launched B1 exactly once a call
(or never). A failed check prints ``{"check_failed": ...}`` on stderr and
exits 1. ``--smoke``: 16,384 slots, 256 queries, 2 trials. ``--device
cpu`` runs the kernel's plain version (times mean nothing there).
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

from lshrs_tpu_torch.ops.group_max import group_max_keys, key_scale  # noqa: E402
from lshrs_tpu_torch.ops.scan import (  # noqa: E402
    collision_final_topk,
    collision_topk_grouped_core,
    gather_refine,
    refine_counts_vs_query,
    select_top_groups,
)

NUM_BANDS, ROWS_PER_BAND, DIM = 16, 16, 768
HASH_SEED = 42
DATA_SEED = 0
N_ITER = 16
METRIC = "kernel_profile"
SMOKE = dict(cap=1 << 14, q=256, trials=2)


def build(args, device):
    """The store holding ``--cap`` hashed rows, its query words and rows."""
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    hasher = LSHHasher(NUM_BANDS, ROWS_PER_BAND, DIM, seed=HASH_SEED, device=device)
    x = np.random.default_rng(DATA_SEED).standard_normal((args.cap, DIM)).astype(np.float32)
    xq = torch.from_numpy(x[: args.q]).to(device)
    words = hasher.hash_batch_words(torch.from_numpy(x).to(device))
    del x
    store = DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
                        initial_capacity=args.cap, group_size=args.group, dedupe=False,
                        device=device)
    store.add_signature_batch(np.arange(args.cap), words)
    store._ensure_ranks()
    return hasher, store, words, xq


def profile(args, device, answers) -> None:
    dev_card = st.card(device)
    hasher, store, words, xq = build(args, device)
    qw = words[: args.q].contiguous()
    sig_t, tie, ids = store._sig_t, store._tie, store._ids
    rows, narrow_r, group = store._refine_rows(), store._refine_narrow_r, store._group()
    scale = key_scale(store._capacity)
    m = min(args.k, store._capacity // group)
    k = args.k
    common = dict(device=device, n_iter=N_ITER, trials=args.trials, dev_card=dev_card, q=args.q)
    b1 = {"b1": 1}

    def row(label, fn, stage=None, per_call=None):
        return st.timed_row(METRIC, label, fn, stage=stage, per_call=per_call, **common)

    def kernel():
        return group_max_keys(sig_t, tie, qw, num_bands=NUM_BANDS, words=1, group=group,
                              scale=scale)

    def core(sig_rows, nr):
        return collision_topk_grouped_core(sig_t, tie, qw, sig_rows, num_bands=NUM_BANDS, k=k,
                                           group=group, narrow_r=nr, ids=ids)

    kern = row("gmax kernel only", kernel, "kernel", b1)
    gmax = kern["out"]
    slot = row("kernel+select+refine", lambda: core(None, 0), per_call=b1)
    full = row("kernel+select+row-refine", lambda: core(rows, narrow_r), "full", b1)
    top = row("kernel+topk", lambda: torch.topk(kernel(), m, dim=1), per_call=b1)["out"]
    row(f"device hash Q={args.q}", lambda: hasher.hash_batch_words(xq))

    sel = row("select", lambda: select_top_groups(gmax, m), "select")
    gat = row("gather", lambda: gather_refine(rows, sig_t, tie, ids, sel["out"],
                                              num_bands=NUM_BANDS, group=group,
                                              narrow_r=narrow_r), "gather")
    cwords, cand_tie, cand_ids, nr = gat["out"]
    rec = row("recount", lambda: refine_counts_vs_query(cwords, qw, num_bands=NUM_BANDS, words=1,
                                                        narrow_r=nr), "recount")
    fin = row("final top-k", lambda: collision_final_topk(rec["out"], cand_tie, cand_ids, k=k,
                                                          scale=scale), "final_top_k")
    serve = store.snapshot_query_fn(k)
    served = row("served", lambda: serve(qw), "served", b1)

    counts, got_ids = full["out"]
    st.check(st.same(fin["out"], full["out"]), "stages_equal_full", "the composed stages differ")
    st.check(st.same(slot["out"], full["out"]), "slot_refine_equal_full", "per-slot != grouped")
    st.check(st.same(served["out"], got_ids), "served_equal_full", "served ids != the core's")
    st.check(st.same(top.indices, sel["out"]), "topk_equal_select", "kernel+topk != select")
    self_match = float((got_ids[:, 0].cpu() == torch.arange(args.q)).float().mean())
    st.check(self_match == 1.0, "self_match", self_match)

    stages = {r["stage"]: r["ms"] for r in (kern, sel, gat, rec, fin)}
    st.emit({"metric": f"{METRIC}_summary", "cap": args.cap, "q": args.q, "k": k, "group": group,
             "capacity": store._capacity, "narrow_r": narrow_r, "stages_ms": stages,
             "stage_sum_ms": sum(stages.values()), "full_ms": full["ms"],
             "served_ms": served["ms"], "served_issue_ms": served["issue_ms"],
             "served_wall_ms": served["wall_ms"],
             "device": dev_card})
    if answers is not None:
        answers.update(words=words.cpu().numpy(), qwords=qw.cpu().numpy(),
                       capacity=store._capacity, group=group, counts=counts.cpu().numpy(),
                       ids=got_ids.cpu().numpy(), served=served["out"].cpu().numpy())


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap", type=int, default=131072)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--group", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--smoke", action="store_true", help="small sizes, every row kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    device = st.resolve_device(args.device, "torch_kernel_profile")
    if device is None:
        return 1
    return st.run_checked(profile, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
