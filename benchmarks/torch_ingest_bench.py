"""Store-level ingest on one GPU: the dense-wire signature append rate at 1M.

The port of ``benchmarks/ingest_bench.py`` to ``lshrs_tpu_torch``: the
same arguments, defaults and JSON fields. 2**20 gaussian rows of 256
dimensions (``default_rng(0)``, drawn batch by batch) are hashed on the
host to the 32-byte dense wire (``LSHHasher.hash_batch_dense_host``, 16
bands, seed 42) before any clock starts, so the run times the store alone:
each trial builds a fresh ``DeviceStore(initial_capacity=n,
dedupe=False)``, feeds it every 131,072-row batch through
``add_signature_batch(ids, dense)`` (a pageable host-to-device copy of the
wire, decoded to words on the card, written in place), synchronizes, and
closes the store. One warm trial, then the best of ``--trials``.

Usage, from the repository root:

    python3 benchmarks/torch_ingest_bench.py [--n 1048576] [--dim 256] [--num-perm 256]
        [--batch 131072] [--trials 3] [--smoke] [--device cuda|cpu]

Prints one JSON line with the reference's fields (``platform`` is
``"gpu"``) and adds every trial's seconds (the warm one first), the
launches of the timed trials, the card (``nvidia-smi`` name and power
limit), the run's seconds and its peak device bytes. ``build_s`` ends at a
``torch.cuda.synchronize`` (the reference's at a read of 8 stored ids).
Checks, after each trial's clock: on the card no kernel launched; the
store holds ``n`` rows; the words stored at a seeded sample of slots (the
first and last too) equal a NumPy decode of those rows' wire, and the ids
there are the slots' own. A failed check prints ``{"check_failed": ...}``
on stderr and exits 1. ``--smoke``: 2**17 rows in 16,384-row batches, 2
trials. ``--device cpu`` runs the same path on the host.
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
HASH_SEED = 42
SAMPLE_SEED = 1
SAMPLE = 256
SMOKE = dict(n=1 << 17, batch=1 << 14, trials=2)


def decode_dense_np(dense: np.ndarray, *, num_bands: int, rows_per_band: int) -> np.ndarray:
    """The dense wire's rows as ``(n, num_bands * W)`` uint32 words, by NumPy
    (unpack each band's little-endian bytes to its sign bits and pack them
    again into words): the host's own decode, beside the store's on the
    device."""
    from lshrs_tpu_torch.ops.bitpack import bytes_per_band, pack_bits_to_words_np

    n = dense.shape[0]
    banded = dense.reshape(n, num_bands, bytes_per_band(rows_per_band))
    bits = np.unpackbits(banded, axis=-1, bitorder="little")[..., :rows_per_band]
    return pack_bits_to_words_np(bits.reshape(n, -1), num_bands=num_bands,
                                 rows_per_band=rows_per_band)


def run(args, device, answers) -> None:
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    t_run = time.perf_counter()
    st.reset_peak(device)
    dev_card = st.card(device)
    rows = args.num_perm // 16
    rng = np.random.default_rng(DATA_SEED)
    h = LSHHasher(num_bands=16, rows_per_band=rows, dim=args.dim, seed=HASH_SEED, device=device)
    # Pre-hash outside the timed region: this bench isolates the store.
    batches = []
    for start in range(0, args.n, args.batch):
        m = min(args.batch, args.n - start)
        X = rng.standard_normal((m, args.dim)).astype(np.float32)
        batches.append((np.arange(start, start + m, dtype=np.int64), h.hash_batch_dense_host(X)))
    wire = np.concatenate([dense for _, dense in batches])
    sample = np.union1d(
        np.random.default_rng(SAMPLE_SEED).choice(args.n, min(SAMPLE, args.n), replace=False),
        [0, args.n - 1])
    want = decode_dense_np(wire[sample], num_bands=16, rows_per_band=rows)

    def trial() -> float:
        store = DeviceStore(num_bands=16, rows_per_band=rows, initial_capacity=args.n,
                            dedupe=False, device=device)
        st.sync(device)
        t0 = time.perf_counter()
        for ids_b, dense in batches:
            store.add_signature_batch(ids_b, dense)
        st.sync(device)
        dt = time.perf_counter() - t0
        st.check(len(store) == args.n, "stored_count", {"want": args.n, "got": len(store)})
        got = st.to_host(store._sig_rows[torch.from_numpy(sample).to(device)]).view(np.uint32)
        st.check(np.array_equal(got, want), "stored_words",
                 "the words stored at the sampled slots differ from the wire's host decode")
        ids = st.to_host(store._ids[torch.from_numpy(sample).to(device)])
        st.check(np.array_equal(ids, sample), "stored_ids", "a sampled slot holds another id")
        if answers is not None:
            with store._lock:
                store._ensure_ranks()
                answers.update(words=store.state_arrays()["sig"],
                               ids=st.to_host(store._ids[: args.n]),
                               tie=st.to_host(store._tie[: args.n]),
                               capacity=store._capacity)
        store.close()
        return dt

    before = st.launch_counts()
    trials = [trial()]  # warm
    trials += [trial() for _ in range(args.trials)]
    launches = st.launch_delta(before) if st.counts_launches(device) else None
    st.expect_launches("trial", launches, device)
    best = min(trials[1:])
    if answers is not None:
        answers.update(wire=wire, sample=sample)
    st.emit({
        "metric": "store_ingest_vectors_per_s",
        "n": args.n,
        "num_perm": args.num_perm,
        "batch": args.batch,
        "build_s": best,
        "vectors_per_s": args.n / best,
        "wire_bytes_per_vector": args.num_perm // 8,
        "platform": st.platform(device),
        "trials_s": trials,
        "sampled_slots": int(sample.size),
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
    ap.add_argument("--batch", type=int, default=131_072)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="2**17 rows in 16,384-row batches, 2 trials")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        st.smoke_sizes(ap, args, SMOKE)
    if args.trials < 1 or args.num_perm % 16:
        ap.error("--trials must be positive and --num-perm a multiple of 16 (16 bands)")
    device = st.resolve_device(args.device, "torch_ingest_bench")
    if device is None:
        return 1
    return st.run_checked(run, args, device, answers)


if __name__ == "__main__":
    sys.exit(main())
