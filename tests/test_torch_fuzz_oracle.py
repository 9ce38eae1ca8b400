"""Random operation sequences and threads: the port's store against
`lshrs_tpu` and a NumPy oracle.

The same seeded sequences of appends (with upserts), deletes, compactions
and growth drive a store of each package on the same words; after every
step both must give the oracle's exact (-count, id), (hamming, id) and
(dot, id) answers — collision top-k, multi-probe, packed Hamming,
asymmetric ranking, the cascade with a full pool, and the two top-p
engines. The thread tests drive the port's ``RLock`` store as the
reference's concurrency tests drive its own; every join has a timeout.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops.asymmetric import quantize_coords_np
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

B, R, D = 4, 8, 24
P = B * R
JOIN_S = 60


def _pair(**kw):
    return JaxStore(**kw), TorchStore(device="cpu", **kw)


def _bits(sigs: np.ndarray) -> np.ndarray:
    """(n, B) words -> (n, P) 0/1 bits, band-major, row-minor."""
    return ((sigs[:, :, None] >> np.arange(R)) & 1).reshape(len(sigs), P).astype(np.int64)


def oracle_topk(model: dict, qw3: np.ndarray, k: int):
    """(counts, ids) by (-count, id) under any-probe counting (qw3: (T, B))."""
    ids = np.fromiter(model.keys(), dtype=np.int64)
    sigs = np.stack([model[int(i)] for i in ids])
    match = np.zeros((len(ids), B), bool)
    for t in range(qw3.shape[0]):
        match |= sigs == qw3[t][None, :]
    counts = match.sum(-1)
    order = np.lexsort((ids, -counts))[:k]
    return [(int(c), int(i)) for c, i in zip(counts[order], ids[order]) if c > 0]


def oracle_hamming(model: dict, qw: np.ndarray, k: int):
    ids = np.fromiter(model.keys(), dtype=np.int64)
    dist = np.abs(_bits(np.stack([model[int(i)] for i in ids])) - _bits(qw[None, :])).sum(1)
    order = np.lexsort((ids, dist))[:k]
    return list(zip(dist[order].tolist(), ids[order].tolist()))


def oracle_asymmetric(model: dict, qc: np.ndarray, k: int):
    ids = np.fromiter(model.keys(), dtype=np.int64)
    planes = 2 * _bits(np.stack([model[int(i)] for i in ids])) - 1
    dots = planes @ qc.astype(np.int64)
    order = np.lexsort((ids, -dots))[:k]
    return list(zip(dots[order].tolist(), ids[order].tolist()))


def _rows(a, b, keep=lambda x, i: i >= 0):
    return [[(int(x), int(i)) for x, i in zip(ra, rb) if keep(x, i)] for ra, rb in zip(a, b)]


class Sequence:
    """Seeded append / upsert / delete / compact steps applied to several
    stores at once, with the NumPy model they must all agree with."""

    def __init__(self, seed: int, stores, *, dedupe: bool = True, vectors: bool = False):
        self.rng = np.random.default_rng(seed)
        self.h = LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=99)
        self.stores, self.dedupe, self.vectors = stores, dedupe, vectors
        self.model: dict[int, np.ndarray] = {}
        self.vecs: dict[int, np.ndarray] = {}
        self.next_id = 0

    def step(self, max_n: int = 20) -> None:
        op = self.rng.integers(0, 10)
        if op < 6:
            n = int(self.rng.integers(1, max_n))
            ids = []
            for _ in range(n):
                if self.model and self.dedupe and self.rng.integers(0, 2) == 0:
                    ids.append(int(self.rng.choice(list(self.model))))  # upsert
                else:
                    ids.append(self.next_id)
                    self.next_id += 1
            X = self.rng.standard_normal((n, D)).astype(np.float32)
            if self.model and self.rng.integers(0, 3) == 0:  # a near-duplicate
                X[0] = self.vecs[int(self.rng.choice(list(self.vecs)))] + 0.01
            words = self.h.hash_batch_words_host(X)
            for s in self.stores:
                s.add_signature_batch(np.asarray(ids), words, X if self.vectors else None)
            for i, w, v in zip(ids, words, X):  # the last occurrence wins
                self.model[i], self.vecs[i] = w, v
        elif op < 8 and self.model:
            size = min(len(self.model), int(self.rng.integers(1, 6)))
            dels = [int(i) for i in self.rng.choice(list(self.model), size=size, replace=False)]
            for s in self.stores:
                s.remove_indices(dels)
            for i in dels:
                self.model.pop(i)
                self.vecs.pop(i)
        elif op == 8:
            for s in self.stores:
                s.compact()
        for s in self.stores:
            assert len(s) == len(self.model)

    def queries(self, q: int) -> np.ndarray:
        return self.rng.standard_normal((q, D)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dedupe", [True, False])
def test_fuzz_random_op_sequences(seed, dedupe, rng):
    """Collision top-k after every step, packed Hamming at the end."""
    js, ts = _pair(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64,
                   dedupe=dedupe, enable_hamming=True, hamming_storage="packed")
    seq = Sequence(seed, (js, ts), dedupe=dedupe)
    for step in range(25):
        seq.step()
        qw = seq.h.hash_batch_words_host(seq.queries(3))
        got = ts.query_topk(qw, 5)
        np.testing.assert_array_equal(got[1], js.query_topk(qw, 5)[1])
        if seq.model:
            rows = _rows(*got, keep=lambda c, i: c > 0 and i >= 0)
            assert rows == [oracle_topk(seq.model, qw[r:r + 1], 5) for r in range(3)], step
    if seq.model:
        qw = seq.h.hash_batch_words_host(seq.queries(2))
        got = ts.query_hamming(qw, 4)
        np.testing.assert_array_equal(got[0], js.query_hamming(qw, 4)[0])
        np.testing.assert_array_equal(got[1], js.query_hamming(qw, 4)[1])
        assert _rows(*got) == [oracle_hamming(seq.model, qw[r], 4)[:len(_rows(*got)[r])]
                               for r in range(2)]


@pytest.mark.parametrize("seed", [3, 4])
def test_fuzz_rerank_engines_agree(seed, rng):
    """Full and gather top-p agree with each other and with the reference's
    full engine after every step; the nnz probe matches the model."""
    kw = dict(num_bands=B, rows_per_band=R, dim=D, store_vectors=True, chunk_size=64,
              initial_capacity=256, group_size=16)
    js, ts = _pair(**kw)
    seq = Sequence(seed, (js, ts), vectors=True)
    for _ in range(12):
        seq.step(15)
        if not seq.model:
            continue
        q = seq.queries(2)
        qw = seq.h.hash_batch_words_host(q)
        ids = np.fromiter(seq.model, dtype=np.int64)
        sigs = np.stack([seq.model[int(i)] for i in ids])
        n_exp = [int((sigs == qw[r][None, :]).any(-1).sum()) for r in range(2)]
        assert ts.query_nnz(qw).tolist() == n_exp
        f = ts.query_topp_batch(qw, q, 8, engine="full")
        g = ts.query_topp_batch(qw, q, 8, engine="gather", max_candidates=64)
        j = js.query_topp_batch(qw, q, 8, engine="full")
        for other in (g, j):
            np.testing.assert_array_equal(other[2], f[2])
            np.testing.assert_array_equal(other[0], f[0])
            valid = f[0] >= 0
            np.testing.assert_allclose(np.asarray(other[1])[valid], f[1][valid], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_fuzz_multiprobe_sequences(seed, rng):
    js, ts = _pair(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64)
    seq = Sequence(seed, (js, ts))
    for step in range(18):
        seq.step(16)
        if not seq.model:
            continue
        T = int(seq.rng.integers(2, 5))
        qw3 = seq.h.hash_batch_probe_words_host(seq.queries(2), T)
        got = ts.query_topk(qw3, 6)
        np.testing.assert_array_equal(got[1], js.query_topk(qw3, 6)[1])
        assert _rows(*got, keep=lambda c, i: c > 0 and i >= 0) == [
            oracle_topk(seq.model, qw3[r], 6) for r in range(2)], step
        nnz = ts.query_nnz(qw3)
        np.testing.assert_array_equal(nnz, js.query_nnz(qw3))
        assert nnz.tolist() == [len(oracle_topk(seq.model, qw3[r], len(seq.model)))
                                for r in range(2)]


@pytest.mark.parametrize("seed", [8, 9])
def test_fuzz_asymmetric_and_cascade_sequences(seed, rng):
    """Asymmetric ranking (planes) and the cascade (a pool covering the
    store) after every step: equal to the reference and to the oracle."""
    kw = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64,
              enable_hamming=True, group_size=16)
    ja, ta = _pair(**kw)
    # A 32-bit signature has no 32-bit prefix below num_perm: the cascade
    # stores hold each signature twice over (8 bands of 8, 64 bits).
    jc, tc = _pair(hamming_cascade=32, hamming_cascade_refine=1 << 16,
                   **dict(kw, num_bands=2 * B))
    seq = Sequence(seed, (ja, ta))
    for step in range(15):
        before = dict(seq.model)
        seq.step(16)
        # mirror the step on the cascade stores: words doubled to 8 bands
        changed = {i: w for i, w in seq.model.items() if i not in before or
                   not np.array_equal(before[i], w)}
        gone = [i for i in before if i not in seq.model]
        if changed:
            ids = np.fromiter(changed, dtype=np.int64)
            w8 = np.concatenate([np.stack(list(changed.values()))] * 2, axis=1)
            for s in (jc, tc):
                s.add_signature_batch(ids, w8)
        for s in (jc, tc):
            s.remove_indices(gone)
        if not seq.model:
            continue
        q = seq.queries(3)
        qc = quantize_coords_np(seq.h.hash_batch_coords_host(q))[0]
        got = ta.query_asymmetric(qc, 5)
        want = ja.query_asymmetric(qc, 5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert _rows(*got) == [oracle_asymmetric(seq.model, qc[r], 5) for r in range(3)], step
        qw = seq.h.hash_batch_words_host(q)
        qw8 = np.concatenate([qw, qw], axis=1)
        got = tc.query_hamming(qw8, 5)
        want = jc.query_hamming(qw8, 5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert len(tc) == len(seq.model)
        assert _rows(*got) == [
            [(2 * h, i) for h, i in oracle_hamming(seq.model, qw[r], 5)] for r in range(3)]


# ---------------------------------------------------------------------------
# threads against the port's RLock store
# ---------------------------------------------------------------------------


def _run(threads) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


def test_concurrent_ingest_device_store():
    lsh = TorchLSHRS(dim=8, num_perm=4, num_bands=2, rows_per_band=2, chunk_size=128,
                     initial_capacity=128, buffer_size=10_000, device="cpu")
    vectors = np.random.default_rng(2).standard_normal((8, 25, 8)).astype(np.float32)

    def worker(tid: int) -> None:
        for j in range(25):
            lsh.ingest(tid * 25 + j, vectors[tid, j])

    _run([threading.Thread(target=worker, args=(t,)) for t in range(8)])
    lsh.flush()
    assert lsh.stats()["index"]["alive"] == 200
    assert lsh.stats()["counters"]["vectors_ingested"] == 200


def test_device_store_threaded_appends_and_queries():
    """Appends and queries from threads: no lost update, every id found."""
    h = LSHHasher(num_bands=2, rows_per_band=8, dim=16, seed=0)
    store = TorchStore(num_bands=2, rows_per_band=8, chunk_size=128, initial_capacity=128,
                       enable_hamming=True, device="cpu")
    X = np.random.default_rng(3).standard_normal((16, 20, 16)).astype(np.float32)
    words = [h.hash_batch_words_host(X[t]) for t in range(16)]
    qc = [quantize_coords_np(h.hash_batch_coords_host(X[t][:4]))[0] for t in range(16)]
    errors: list[Exception] = []

    def writer(tid: int) -> None:
        try:
            ids = np.arange(tid * 20, tid * 20 + 20)
            for j in range(0, 20, 5):
                store.add_signature_batch(ids[j : j + 5], words[tid][j : j + 5])
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def reader(tid: int) -> None:
        try:
            for _ in range(10):
                store.query_topk(words[tid][:4], 5)
                store.query_asymmetric(qc[tid], 5)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: lost updates show
    try:
        _run([threading.Thread(target=writer, args=(t,)) for t in range(8)]
             + [threading.Thread(target=reader, args=(t,)) for t in range(8)])
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert len(store) == 160
    for tid in range(8):
        assert store.query_topk(words[tid][:1], 1)[1][0][0] == tid * 20


def test_device_store_compact_holds_lock_against_writers():
    """compact() does not erase appends that land while it runs."""
    h = LSHHasher(num_bands=2, rows_per_band=8, dim=16, seed=1)
    store = TorchStore(num_bands=2, rows_per_band=8, chunk_size=128, initial_capacity=128,
                       device="cpu")
    X = np.random.default_rng(4).standard_normal((120, 16)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    store.add_signature_batch(np.arange(100), words[:100])
    store.remove_indices(list(range(0, 100, 2)))
    stop = threading.Event()

    def compactor() -> None:
        while not stop.is_set():
            store.compact()

    t = threading.Thread(target=compactor)
    t.start()
    try:
        for j in range(100, 120):
            store.add_signature_batch([j], words[j : j + 1])
    finally:
        stop.set()
        t.join(timeout=JOIN_S)
    assert not t.is_alive()
    store.compact()
    assert len(store) == 70
    for j in (100, 110, 119):
        assert store.query_topk(words[j : j + 1], 1)[1][0][0] == j


@pytest.mark.parametrize("mode", ["collision", "asymmetric"])
def test_snapshot_closure_race_with_append(mode, rng):
    """A snapshot racing appends serves the state it captured or raises the
    stale RuntimeError, and nothing else."""
    h = LSHHasher(num_bands=4, rows_per_band=8, dim=16, seed=0)
    X = rng.standard_normal((600, 16)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    qin = words[:8] if mode == "collision" else quantize_coords_np(
        h.hash_batch_coords_host(X[:8]))[0]
    store = TorchStore(num_bands=4, rows_per_band=8, dim=16, store_vectors=True,
                       chunk_size=128, initial_capacity=2048, enable_hamming=True,
                       device="cpu")
    store.add_signature_batch(np.arange(200), words[:200], X[:200])
    stop = threading.Event()
    errs: list[Exception] = []

    def writer() -> None:
        i = 200
        while not stop.is_set() and i < 600:
            store.add_signature_batch(np.arange(i, i + 10), words[i : i + 10], X[i : i + 10])
            i += 10

    def snapshotter() -> None:
        for _ in range(30):
            try:
                store.snapshot_query_fn(3, mode=mode)(qin)
            except RuntimeError as e:
                if "stale" not in str(e):
                    errs.append(e)
            except Exception as e:  # pragma: no cover - failure reporting
                errs.append(e)

    t1, t2 = threading.Thread(target=writer), threading.Thread(target=snapshotter)
    t1.start()
    t2.start()
    t2.join(timeout=JOIN_S)
    stop.set()
    t1.join(timeout=JOIN_S)
    assert not t1.is_alive() and not t2.is_alive()
    assert not errs, errs
