"""Stage-level profile of the host-streamed build path on one GPU.

The port of ``benchmarks/ingest_profile.py`` to ``lshrs_tpu_torch``: the
same arguments and defaults (``--n 1048576 --dim 768 --chunk 131072
--hash-family structured``), the same stages and the same keys. Every
stage times one piece of ``LSHHasher.hash_batch_dense_host`` +
``DeviceStore.add_signature_batch`` per chunk, summed over the chunks:

    hash              the host hash and dense bitpack (CPU-bound)
    upload_blocking   the dense wire copied to the card, then a synchronize
    append_dispatch   ``add_signature_batch`` (its device decode and append
                      are queued; the host's bookkeeping runs)
    final_barrier     the readback of 8 ids and a ``torch.cuda.synchronize()``
                      after the last chunk

then the build rates of a ``serial`` build (the stages above in a row),
a ``chunked_async`` loop (hash chunk i+1 while the card appends chunk i,
one barrier at the end), a ``monolithic`` build (one ``n``-row batch,
after one warm-up of the same shape and a ``clear()``) and the host hash
alone (``hash_only``). No kernel runs on this path. Data:
``default_rng(0)`` chunks of ``--chunk`` rows, ids ``0 .. n-1``, hasher
seed 42.

Usage, from the repository root:

    python3 benchmarks/torch_ingest_profile.py [--n 1048576] [--dim 768]
        [--chunk 131072] [--hash-family structured] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's keys, the card's name and power
limit and the chunk count. Checks: the serial, chunked and monolithic
builds leave identical ``state_arrays()``, and 256 stored rows, queried
with their own words, find themselves first (self-match 1.0). A failed
check prints ``{"check_failed": ...}`` on stderr and exits 1. ``--smoke``:
65,536 rows in 16,384-row chunks. ``--device cpu`` runs the same build on
CPU tensors (the rates then measure the host only).
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

NUM_BANDS, ROWS_PER_BAND = 16, 16
HASH_SEED = 42
DATA_SEED = 0
SELF_MATCH_ROWS = 256
SMOKE = dict(n=1 << 16, chunk=1 << 14)


def barrier(store, device) -> float:
    """Seconds to read back 8 ids and drain the device's queue."""
    t0 = time.perf_counter()
    store._ids[:8].cpu()
    st.sync(device)
    return time.perf_counter() - t0


def profile(args, device, answers) -> None:
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    dev_card = st.card(device)
    rng = np.random.default_rng(DATA_SEED)
    hasher = LSHHasher(NUM_BANDS, ROWS_PER_BAND, args.dim, seed=HASH_SEED,
                       hash_family=args.hash_family, device=device)

    def fresh_store():
        return DeviceStore(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=args.dim,
                           initial_capacity=args.n, dedupe=False, device=device)

    n, chunk = args.n, args.chunk
    chunks = [rng.standard_normal((chunk, args.dim)).astype(np.float32) for _ in range(n // chunk)]
    ids = [np.arange(i * chunk, (i + 1) * chunk) for i in range(n // chunk)]

    # warm every shape
    store = fresh_store()
    store.add_signature_batch(ids[0], hasher.hash_batch_dense_host(chunks[0]))
    barrier(store, device)

    # stage timings (serial, summed over the chunks)
    store = fresh_store()
    t_hash = t_upload = t_append = 0.0
    t0_all = time.perf_counter()
    for xb, idb in zip(chunks, ids):
        t0 = time.perf_counter()
        dense = hasher.hash_batch_dense_host(xb)
        t1 = time.perf_counter()
        dense_dev = torch.from_numpy(dense).to(device)
        st.sync(device)
        t2 = time.perf_counter()
        store.add_signature_batch(idb, dense_dev)
        t3 = time.perf_counter()
        t_hash += t1 - t0
        t_upload += t2 - t1
        t_append += t3 - t2
    t_barrier = barrier(store, device)
    serial_s = time.perf_counter() - t0_all

    # chunked loop: no synchronize until the end
    store2 = fresh_store()
    t0 = time.perf_counter()
    for xb, idb in zip(chunks, ids):
        store2.add_signature_batch(idb, hasher.hash_batch_dense_host(xb))
    barrier(store2, device)
    chunked_s = time.perf_counter() - t0

    # monolithic: one n-row batch, its shapes warmed first
    store3 = fresh_store()
    x_all = np.concatenate(chunks)
    all_ids = np.concatenate(ids)
    store3.add_signature_batch(all_ids, hasher.hash_batch_dense_host(x_all))
    store3.clear()
    t0 = time.perf_counter()
    store3.add_signature_batch(all_ids, hasher.hash_batch_dense_host(x_all))
    barrier(store3, device)
    mono_s = time.perf_counter() - t0

    # the host hash alone
    t0 = time.perf_counter()
    for xb in chunks:
        hasher.hash_batch_dense_host(xb)
    hash_only_s = time.perf_counter() - t0

    states = [s.state_arrays() for s in (store, store2, store3)]
    for name, other in zip(("chunked_async", "monolithic"), states[1:]):
        st.check(all(np.array_equal(states[0][k], other[k]) for k in ("ids", "sig")),
                 f"{name}_state_equal_serial", "state_arrays() differ")
    probe = hasher.hash_batch_dense_host(x_all[:SELF_MATCH_ROWS])
    got = store.snapshot_query_fn(1, wire="dense")(probe).cpu().numpy()
    self_match = float((got[:, 0] == np.arange(len(probe))).mean())
    st.check(self_match == 1.0, "self_match", self_match)

    st.emit({
        "metric": "streamed_ingest_profile",
        "n": n,
        "chunk": chunk,
        "chunks": len(chunks),
        "hash_family": args.hash_family,
        "stages_s": {
            "hash": t_hash,
            "upload_blocking": t_upload,
            "append_dispatch": t_append,
            "final_barrier": t_barrier,
        },
        "serial_vectors_per_s": n / serial_s,
        "chunked_async_vectors_per_s": n / chunked_s,
        "monolithic_vectors_per_s": n / mono_s,
        "hash_only_vectors_per_s": n / hash_only_s,
        "self_match": self_match,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": dev_card,
    })
    if answers is not None:
        answers.update(x=x_all, ids=all_ids, states=states, self_ids=got)


def main(argv=None, *, answers: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--chunk", type=int, default=1 << 17)
    ap.add_argument("--hash-family", default="structured")
    ap.add_argument("--smoke", action="store_true", help="small sizes, every stage kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    device = st.resolve_device(args.device, "torch_ingest_profile")
    if device is None:
        return 1
    return st.run_checked(profile, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
