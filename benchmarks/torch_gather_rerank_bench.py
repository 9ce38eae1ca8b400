"""Gather vs full top-p rerank engine: device cost against capacity on one GPU.

The port of ``benchmarks/gather_rerank_bench.py`` to ``lshrs_tpu_torch``:
the same arguments and defaults (``--caps 131072,1048576 --query-batch
1024 --max-candidates 1024 --dispatches 8 --payload-dtype float32
--engines full,gather``), the same JSON rows and summary. The full
engine's ``(Q, C)`` counts and cosines scale with the capacity; the
gather engine's cost (kernel B1 selects the ``--max-candidates`` most
colliding slots per query, then only those rows are reranked) scales
with the candidate budget.

Each capacity's store (``store_vectors=True``, ``chunk_size=2048``,
16 bands of ``num_perm / 16`` rows) is built with the fused hash + append
(``add_vectors_batch`` with ``LSHHasher.device_projection()``) from
gaussian rows drawn on the card per ``(seed, offset)`` in 2**18-row
steps; the queries are drawn on the card too (seed 7) and hashed there.
Each engine serves through ``snapshot_topp_fn(10, wire="words",
engine=..., max_candidates=...)``: warmed up, then ``--dispatches``
back-to-back calls timed with CUDA events (median over ``--trials``;
``*_issue_ms_per_batch``, the host's time to enqueue one, and
``*_wall_ms_per_batch`` by the host's clock). ``mean_candidates`` and
``truncated_frac`` are the gather engine's candidate counts ``n`` on the
timed queries.

Usage, from the repository root:

    python3 benchmarks/torch_gather_rerank_bench.py [--caps 131072,1048576]
        [--dim 768] [--num-perm 256] [--query-batch 1024] [--max-candidates 1024]
        [--dispatches 8] [--payload-dtype float32|bfloat16|int8]
        [--engines full,gather] [--trials 3] [--smoke] [--device cuda|cpu]

Prints one ``gather_vs_full_rerank`` JSON line per capacity (with each
engine's launches and the card's name and power limit), then the
``gather_rerank_sweep_summary`` line. Checks (the port's own: the
reference's queries are fresh draws): on a probe of the first 64 stored
rows both engines find each row first and return the same ids wherever
the row's colliding set fits the gather budget (``probe_exact_queries``
of them; the gather engine is exact there); on the
card the gather engine launched B1 exactly once per query slice of each
call and the full engine never. A failed check prints ``{"check_failed":
...}`` on stderr and exits 1. ``--smoke``: 65,536 slots, 256 queries, 4
dispatches, 2 trials. ``--device cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_stage_timing as st  # noqa: E402

NUM_BANDS = 16
HASH_SEED = 42
DATA_SEED = 0
QUERY_SEED = 7
STEP = 1 << 18
PROBE = 64
TOP = 10
SMOKE = dict(caps="65536", query_batch=256, dispatches=4, trials=2)


def build_store(n: int, hasher, args, device):
    from lshrs_tpu_torch import DeviceStore

    store = DeviceStore(num_bands=NUM_BANDS, rows_per_band=args.num_perm // NUM_BANDS,
                        dim=args.dim, store_vectors=True, initial_capacity=n, dedupe=False,
                        chunk_size=2048, payload_dtype=args.payload_dtype, device=device)
    proj = hasher.device_projection()
    for off in range(0, n, STEP):
        m = min(STEP, n - off)
        store.add_vectors_batch(np.arange(off, off + m),
                                st.draw_rows(DATA_SEED, off, m, args.dim, device), proj)
    st.check(len(store) == n, "store_size", len(store))
    return store


def run_cap(n: int, hasher, args, device, dev_card, answers) -> dict:
    store = build_store(n, hasher, args, device)
    qx = st.draw_rows(QUERY_SEED, 0, args.query_batch, args.dim, device)
    qw = hasher.hash_batch_words(qx)
    probe_x = st.draw_rows(DATA_SEED, 0, min(PROBE, n), args.dim, device)
    probe_w = hasher.hash_batch_words(probe_x)
    row = {"n": n}
    launches, probe_ids, served = {}, {}, {}
    for engine in args.engines.split(","):
        serve = store.snapshot_topp_fn(TOP, wire="words", engine=engine,
                                       max_candidates=args.max_candidates)
        before = st.launch_counts()
        t = st.stage_ms(lambda: serve(qw, qx), n_iter=args.dispatches, trials=args.trials,
                        device=device)
        got = st.launch_delta(before) if st.counts_launches(device) else None
        launches[engine] = got
        slices = -(-args.query_batch // store._topp_dev_batch(engine, args.max_candidates))
        st.expect_launches(f"{engine}_{n}", got, device,
                           b1=t["calls"] * slices if engine == "gather" else 0)
        ids, _, nvals = t["out"]
        served[engine] = (ids.cpu().numpy(), nvals.cpu().numpy())
        row[f"{engine}_ms_per_batch"] = t["ms"]
        row[f"{engine}_issue_ms_per_batch"] = t["issue_ms"]
        row[f"{engine}_wall_ms_per_batch"] = t["wall_ms"]
        row[f"{engine}_qps_device"] = 1000 * args.query_batch / t["ms"]
        if engine == "gather":
            nv = served[engine][1]
            row["mean_candidates"] = float(nv.mean())
            row["truncated_frac"] = float((nv >= args.max_candidates).mean())
        p_ids, _, p_n = serve(probe_w, probe_x)
        probe_ids[engine] = (p_ids.cpu().numpy(), p_n.cpu().numpy())
        own = float((probe_ids[engine][0][:, 0] == np.arange(len(p_ids))).mean())
        st.check(own == 1.0, f"self_match_{engine}_{n}", own)
        del serve
    if "full" in probe_ids and "gather" in probe_ids:
        # The gather engine is exact where a query's colliding set fits
        # its budget (n below it); there it must equal the full engine.
        fits = probe_ids["gather"][1] < args.max_candidates
        row["probe_exact_queries"] = int(fits.sum())
        st.check(np.array_equal(probe_ids["full"][0][fits], probe_ids["gather"][0][fits]),
                 f"gather_equal_full_{n}", "probe ids differ where the candidates fit")
    if "full_ms_per_batch" in row and "gather_ms_per_batch" in row:
        row["speedup"] = row["full_ms_per_batch"] / row["gather_ms_per_batch"]
    if answers is not None:
        state = store.state_arrays()
        answers[n] = dict(words=state["sig"], payload=state["payload"], ids=state["ids"],
                          capacity=store._capacity, qwords=qw.cpu().numpy(),
                          qx=qx.cpu().numpy(), probe_words=probe_w.cpu().numpy(),
                          probe_x=probe_x.cpu().numpy(), served=served, probe_ids=probe_ids)
    store.close()
    st.emit({"metric": "gather_vs_full_rerank", **row, "launches": launches,
             "device": dev_card})
    return row


def sweep(args, device, answers) -> None:
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    dev_card = st.card(device)
    hasher = LSHHasher(NUM_BANDS, args.num_perm // NUM_BANDS, args.dim, seed=HASH_SEED,
                       device=device)
    rows = [run_cap(int(c), hasher, args, device, dev_card, answers)
            for c in args.caps.split(",")]
    st.emit({
        "metric": "gather_rerank_sweep_summary",
        "dim": args.dim,
        "num_perm": args.num_perm,
        "query_batch": args.query_batch,
        "max_candidates": args.max_candidates,
        "payload_dtype": args.payload_dtype,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": dev_card,
        "rows": rows,
    })


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", default="131072,1048576",
                    help="comma-separated store sizes to sweep")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--query-batch", type=int, default=1024)
    ap.add_argument("--max-candidates", type=int, default=1024)
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--payload-dtype", choices=["float32", "bfloat16", "int8"],
                    default="float32")
    ap.add_argument("--engines", default="full,gather", help="comma list of full, gather")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--smoke", action="store_true", help="small sizes, both engines kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    device = st.resolve_device(args.device, "torch_gather_rerank_bench")
    if device is None:
        return 1
    return st.run_checked(sweep, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
