"""Interleaved A/B on one GPU: flat `torch.topk` group selection vs blockwise `topk_wide`.

The port of ``benchmarks/ab_serving.py`` to ``lshrs_tpu_torch``: the same
arguments, defaults and JSON fields. Both selection variants serve the
SAME 100k store in ONE process, in strictly interleaved trials (A B A B
...), so drift on the host or the card hits both alike. 100,000 gaussian
rows of 768 dimensions (``default_rng(0)``) are hashed on the host by the
structured 16 x 16 hasher (seed 42) to the dense wire and appended to a
``DeviceStore(chunk_size=2048, initial_capacity=2**17, dedupe=False)``; 6
batches of 16,384 gaussian queries go through the reference's pipeline (a
hasher thread -> one dispatch per batch of ``snapshot_query_fn(10,
wire="dense")`` on this thread -> a reader thread that reads the ids back
with ``.cpu()``), 5 trials a variant. Kernel B1 scores every batch on both
sides; only the selection of the top groups from its ``(Q, C / 64)``
group-max keys differs.

The roles reverse against the reference, whose current code was the
blockwise selector and whose variant A patched in the flat one:

- **A (flat)** is the package's own selection,
  ``lshrs_tpu_torch.ops.scan.select_top_groups``: one ``torch.topk`` over
  the 2,048 group columns of the 2**17-slot store.
- **B (wide)** is a torch port, in this script, of the reference's
  ``topk_wide`` (``lshrs_tpu/ops/scan.py``: each ``block``-column block
  keeps its own top m, round by round, until one flat top-k finishes) and
  ``_hierarchical_top_groups`` (the max of each superchunk of 128 groups,
  the top-m superchunks, then ``topk_wide`` over their groups). At 2,048
  group columns and m = 10 that is 16 superchunks, the top 10 of them, and
  one blockwise round over their 1,280 groups. Both keep ``lax.top_k``'s
  order: the larger key first, the lower position first among equal keys
  (each round ranks an int64 key of the value and the position).
  Variant B swaps ``select_top_groups`` in the module for the length of
  each of its calls, in the thread that calls the closure (the core looks
  the name up at every call); the package's selection does not change.

Usage, from the repository root:

    python3 benchmarks/torch_ab_serving.py [--n 100000] [--q 16384] [--trials 5]
        [--batches 6] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``) and adds each variant's wall ms a batch (its best trial) and
the card's ms a batch of its closure on the first batch's wire held on the
card (``*_device_ms_per_batch``, CUDA events), B's route, the launches of
the timed trials, the card (``nvidia-smi`` name and power limit), the
run's seconds and its peak device bytes. This A/B reports; it chooses
nothing. Checks: the warm-up serves equal ids from A and B (as the
reference asserts); both find each of the first stored rows first (its
own wire as the query); every timed trial of either variant serves the
ids of A's first trial, each in ``[-1, n)``; B's selector ran once per B
batch and never for A; on the card B1 launched exactly once per batch of
each trial and of each device timing, and no other kernel. A failed check
prints ``{"check_failed": ...}`` on stderr and exits 1. ``--smoke``:
1,024-query batches, 2 batches, 2 trials (the 2**17 capacity, which sets
B's route, stays). ``--device cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_stage_timing as st  # noqa: E402

NUM_BANDS, ROWS_PER_BAND, DIM, TOP_K = 16, 16, 768, 10
DATA_SEED = 0
HASH_SEED = 42
SMOKE = dict(q=1024, trials=2, batches=2)
# Each variant's device timing: calls a trial, trials (st.stage_ms).
DEVICE_N_ITER, DEVICE_TRIALS = 4, 3


def _top(key: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the ``m`` largest values and their
    positions (int64), the lower position first among equal values. One
    ``torch.topk`` over the int64 key ``value * 2**32 + (2**32 - 1 -
    position)``, which is distinct per row and orders as that rule does."""
    n = key.shape[-1]
    pos = torch.arange(n, dtype=torch.int64, device=key.device)
    _, p = torch.topk(key.to(torch.int64) * (1 << 32) + ((1 << 32) - 1 - pos), m, dim=-1)
    return key.gather(-1, p), p


def topk_wide(key: torch.Tensor, m: int, *, block: int = 256,
              flat: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-m ``(values, positions)`` of each row of an integer
    ``(Q, n)`` key, blockwise: the port of the reference's
    ``lshrs_tpu.ops.scan.topk_wide``. While a row is wider than ``flat``
    (and ``block``), every ``block``-column block keeps its local top m (a
    global top-m element is always its block's), so the row shrinks by
    about ``m / block`` per round; one flat top-k finishes. Among equal
    keys the lower position wins within each top-k, as in the reference
    (over more than m-way ties across blocks, both may pick another equal
    key's position). Padding is the dtype's minimum."""
    q, n = key.shape
    m = min(m, n)
    block = max(block, 2 * m)
    lowest = torch.iinfo(key.dtype).min
    pos = None
    while n > max(flat, block):
        nb = -(-n // block)
        if nb * block != n:
            pad = torch.full((q, nb * block - n), lowest, dtype=key.dtype, device=key.device)
            key = torch.cat([key, pad], dim=1)
        v, p = _top(key.reshape(q * nb, block), m)
        offsets = torch.arange(nb, dtype=torch.int64, device=key.device) * block
        p = (p.reshape(q, nb, m) + offsets[None, :, None]).reshape(q, nb * m)
        pos = p if pos is None else pos.gather(1, p)
        key = v.reshape(q, nb * m)
        n = key.shape[1]
    v, p = _top(key, m)
    if pos is not None:
        p = pos.gather(1, p)
    return v, p


def hierarchical_top_groups(gmax: torch.Tensor, *, m: int, ngc: int | None = None) -> torch.Tensor:
    """The top-m group indices ``(Q, m)`` int64 of the group-max keys
    ``(Q, ng)``, hierarchically: the port of the reference's
    ``lshrs_tpu.ops.scan._hierarchical_top_groups``. The max of each
    superchunk of ``ngc`` groups (default ``min(ng, 128)``), the top-m
    superchunks by it, then :func:`topk_wide` over their groups; exact on
    distinct keys, since every top-m group lies in a top-m superchunk.
    Rows narrower than 2,048 groups, not a whole number of superchunks, or
    of at most m superchunks take :func:`topk_wide` directly."""
    q, ng = gmax.shape
    if ngc is None:
        ngc = min(ng, 128)
    if not hierarchy_applies(ng, m, ngc):
        return topk_wide(gmax, m)[1]
    nch = ng // ngc
    g3 = gmax.reshape(q, nch, ngc)
    mc = min(m, nch)
    _, top_chunks = topk_wide(g3.amax(dim=-1), mc)
    cand = g3.gather(1, top_chunks[..., None].expand(q, mc, ngc))
    _, pos = topk_wide(cand.reshape(q, mc * ngc), m)
    return top_chunks.gather(1, pos // ngc) * ngc + pos % ngc


def hierarchy_applies(ng: int, m: int, ngc: int) -> bool:
    """Whether :func:`hierarchical_top_groups` takes the superchunks over
    ``ng`` group columns (the reference's condition)."""
    return ng >= 2048 and ng % ngc == 0 and ng // ngc > m


def wide_route(groups: int, m: int = TOP_K) -> str:
    """What :func:`hierarchical_top_groups` runs over ``groups`` columns."""
    ngc = min(groups, 128)
    if not hierarchy_applies(groups, m, ngc):
        return f"topk_wide over {groups} groups"
    return (f"hierarchy: {groups // ngc} superchunks of {ngc} -> top {m} -> topk_wide over "
            f"{m * ngc} groups")


@contextlib.contextmanager
def wide_selection(calls: list):
    """``lshrs_tpu_torch.ops.scan.select_top_groups`` replaced by
    :func:`hierarchical_top_groups` (each call recorded in ``calls``)
    until the block ends."""
    import lshrs_tpu_torch.ops.scan as scan_mod

    real = scan_mod.select_top_groups

    def select(gmax, m):
        calls.append(tuple(gmax.shape))
        return hierarchical_top_groups(gmax, m=m)

    scan_mod.select_top_groups = select
    try:
        yield
    finally:
        scan_mod.select_top_groups = real


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    hasher = LSHHasher(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
                       seed=HASH_SEED, hash_family="structured", device=device)
    store = DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
                        chunk_size=2048, initial_capacity=1 << 17, dedupe=False, device=device)
    rng = np.random.default_rng(DATA_SEED)
    X = rng.standard_normal((args.n, DIM)).astype(np.float32)
    store.add_signature_batch(np.arange(args.n), hasher.hash_batch_dense_host(X))
    raw = [rng.standard_normal((args.q, DIM)).astype(np.float32) for _ in range(args.batches)]
    wires = [hasher.hash_batch_dense_host(b) for b in raw]
    groups = store._capacity // store._group()

    wide_calls: list = []
    serve_a = store.snapshot_query_fn(TOP_K, wire="dense")

    def serve_b(wire):
        with wide_selection(wide_calls):
            return serve_a(wire)

    variants = {"flat": serve_a, "wide": serve_b}
    warm = {name: st.to_host(serve(wires[0])) for name, serve in variants.items()}
    st.check(np.array_equal(warm["flat"], warm["wide"]), "warm_equal",
             "selection variants disagree")
    st.check(len(wide_calls) == 1, "wide_selector_calls", {"want": 1, "got": len(wide_calls)})
    nprobe = min(args.q, args.n)
    probe_wire = hasher.hash_batch_dense_host(X[:nprobe])
    for name, serve in variants.items():
        probe = st.to_host(serve(probe_wire))
        st.check_ids(f"{name}_probe", probe, nprobe, TOP_K, args.n)
        rate = float((probe[:, 0] == np.arange(nprobe)).mean())
        st.check(rate == 1.0, f"{name}_self_match", rate)

    t = {"flat": [], "wide": []}
    first_ids = None
    launches = {}
    for _ in range(args.trials):  # strict interleave: drift hits both
        for name, serve in variants.items():
            calls_before = len(wide_calls)
            before = st.launch_counts()
            dt, out = st.pipelined_trial(hasher.hash_batch_dense_host, serve, st.to_host, raw)
            got = st.launch_delta(before) if st.counts_launches(device) else None
            st.expect_launches(f"{name}_timed", got, device, b1=args.batches)
            launches[name] = got
            want_calls = args.batches if name == "wide" else 0
            st.check(len(wide_calls) - calls_before == want_calls, f"{name}_selector_calls",
                     {"want": want_calls, "got": len(wide_calls) - calls_before})
            for ids in out:
                st.check_ids(f"{name}_timed", ids, args.q, TOP_K, args.n)
            if first_ids is None:
                first_ids = out
            st.check(all(np.array_equal(a, b) for a, b in zip(out, first_ids)),
                     f"{name}_timed_equal", "a trial served other ids than the first")
            t[name].append(dt)
    t_a, t_b = sorted(t["flat"]), sorted(t["wide"])

    wire_dev = torch.from_numpy(wires[0]).to(device)
    device_ms = {}
    for name, serve in variants.items():
        before = st.launch_counts()
        timing = st.stage_ms(lambda serve=serve: serve(wire_dev), n_iter=DEVICE_N_ITER,
                             trials=DEVICE_TRIALS, device=device)
        got = st.launch_delta(before) if st.counts_launches(device) else None
        st.expect_launches(f"{name}_device_ms", got, device, b1=timing["calls"])
        device_ms[name] = timing["ms"]
    if answers is not None:
        answers.update(words=store.state_arrays()["sig"], wires=wires, ids=first_ids,
                       warm=warm["flat"], probe_wire=probe_wire, capacity=store._capacity)

    n_q = args.q * args.batches
    mid_a, mid_b = t_a[len(t_a) // 2], t_b[len(t_b) // 2]
    st.emit({
        "metric": "ab_flat_topk_vs_topk_wide_100k",
        "n": args.n,
        "q_batch": args.q,
        "trials": args.trials,
        "flat_qps_best": n_q / t_a[0],
        "flat_qps_median": n_q / mid_a,
        "wide_qps_best": n_q / t_b[0],
        "wide_qps_median": n_q / mid_b,
        "wide_over_flat_best": t_a[0] / t_b[0],
        "wide_over_flat_median": mid_a / mid_b,
        "platform": st.platform(device),
        "flat_wall_ms_per_batch": 1000 * t_a[0] / args.batches,
        "wide_wall_ms_per_batch": 1000 * t_b[0] / args.batches,
        "flat_device_ms_per_batch": device_ms["flat"],
        "wide_device_ms_per_batch": device_ms["wide"],
        "wide_over_flat_device": device_ms["flat"] / device_ms["wide"],
        "group_columns": groups,
        "wide_route": wide_route(groups),
        "launches": launches,
        "seconds": time.perf_counter() - t_run,
        "peak_device_bytes": st.peak_bytes(device),
        "device": dev_card,
    })


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=16384)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--smoke", action="store_true",
                    help="1,024-query batches, 2 batches, 2 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.trials < 1 or args.batches < 1 or not 0 < args.n <= 1 << 17:
        ap.error("--trials and --batches must be positive and --n within the 2**17 capacity")
    device = st.resolve_device(args.device, "torch_ab_serving")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
