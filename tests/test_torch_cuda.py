"""The hand-written CUDA kernels and the port's main path on a GPU.

Every test here needs an NVIDIA GPU and skips elsewhere (marker ``cuda``;
the check is made in a fixture). The file imports torch, NumPy and the
port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX for the
reference package's tests.) The kernels are held to their plain PyTorch
versions bit for bit, and the GPU store to a CPU store on the same words.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lshrs_tpu_torch import LSHRS
from lshrs_tpu_torch.ops import group_max as gm
from lshrs_tpu_torch.ops.scan import global_tie_core

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels B1/B2/B3 have no CPU build)")
    return torch.device("cuda")


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


def _tie(rng, c, dev):
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    return global_tie_core(torch.from_numpy(ids).to(dev))


@pytest.mark.parametrize(
    "num_bands,words,c,q,probes",
    [
        (16, 1, 4096, 256, 1),
        (16, 1, 4096, 256, 2),
        (16, 1, 4096, 100, 1),  # ragged Q
        (4, 3, 2048, 70, 1),    # generic (non-register) instantiation
        (8, 1, 256, 9, 1),      # store smaller than one block's slot range
    ],
)
def test_b1_kernel_matches_plain(num_bands, words, c, q, probes, dev, rng):
    bw = num_bands * words
    sig = rng.integers(0, 4, (bw, c), dtype=np.int32)
    q0 = rng.integers(0, 4, (q, bw), dtype=np.int32)
    q0[: q // 2] = sig[:, rng.integers(0, c, q // 2)].T  # planted full matches
    qw = np.concatenate([q0 ^ (np.int32(1) << t) if t else q0 for t in range(probes)], 1)
    sig_t = torch.from_numpy(sig).to(dev)
    qwords = torch.from_numpy(np.ascontiguousarray(qw)).to(dev)
    tie = _tie(rng, c, dev)
    kw = dict(num_bands=num_bands, words=words, group=64, scale=gm.key_scale(c), probes=probes)
    before = gm.group_max_keys.launches
    got = gm.group_max_keys(sig_t, tie, qwords, **kw)
    assert gm.group_max_keys.launches == before + 1
    assert got.device == sig_t.device and got.shape == (q, c // 64)
    assert torch.equal(got, gm.group_max_keys_ref(sig_t, tie, qwords, **kw))


@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("q", [128, 77])
def test_b2_kernel_matches_plain(asymmetric, q, dev, rng):
    c, p = 8192, 256
    planes = (2 * rng.integers(0, 2, (c, p), dtype=np.int8) - 1).astype(np.int8)
    if asymmetric:
        qb = rng.integers(-127, 128, (q, p), dtype=np.int16).astype(np.int8)
        kw = dict(offset=p * 127, shift=gm.asymmetric_shift(p, c))
    else:
        qb = planes[rng.integers(0, c, q)].copy()
        kw = {}
    planes_d = torch.from_numpy(planes).to(dev)
    qb_d = torch.from_numpy(qb).to(dev)
    tie = _tie(rng, c, dev)
    kw.update(group=64, scale=gm.key_scale(c))
    before = gm.hamming_group_max_keys.launches
    got = gm.hamming_group_max_keys(planes_d, tie, qb_d, **kw)
    assert gm.hamming_group_max_keys.launches == before + 1
    assert torch.equal(got, gm.hamming_group_max_keys_ref(planes_d, tie, qb_d, **kw))


@pytest.mark.parametrize(
    "bw,c,q,group",
    [
        (16, 8192, 256, 64),
        (16, 8192, 100, 16),  # ragged Q
        (16, 4096, 300, 128),  # Q past one block's 256 queries
        (8, 4096, 77, 32),
        (12, 4096, 70, 64),   # generic (non-register) instantiation
        (16, 256, 9, 64),     # store smaller than one block's 1024 slots
    ],
)
def test_b3_kernel_matches_plain(bw, c, q, group, dev, rng):
    # Full 32-bit words, so num_perm = 32 * BW; half the queries are
    # stored slots with ~10% of their bits flipped.
    sig = rng.integers(-(2**31), 2**31, (bw, c), dtype=np.int64).astype(np.int32)
    qw = rng.integers(-(2**31), 2**31, (q, bw), dtype=np.int64).astype(np.int32)
    flips = np.where(rng.random((q // 2, bw, 32)) < 0.1, 1, 0) << np.arange(32)
    qw[: q // 2] = sig[:, rng.integers(0, c, q // 2)].T ^ flips.sum(-1).astype(np.uint32).view(np.int32)
    sig_t = torch.from_numpy(sig).to(dev)
    qwords = torch.from_numpy(qw).to(dev)
    tie = _tie(rng, c, dev)
    kw = dict(num_perm=32 * bw, group=group, scale=gm.key_scale(c))
    before = gm.hamming_packed_group_max_keys.launches
    got = gm.hamming_packed_group_max_keys(sig_t, tie, qwords, **kw)
    assert gm.hamming_packed_group_max_keys.launches == before + 1
    assert got.device == sig_t.device and got.shape == (q, c // group)
    assert torch.equal(got, gm.hamming_packed_group_max_keys_ref(sig_t, tie, qwords, **kw))


def test_cuda_wrappers_reject_what_the_kernels_cannot_take(dev):
    sig_t = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    tie = torch.full((512,), -1, dtype=torch.int32, device=dev)
    qw = torch.zeros((8, 8), dtype=torch.int32, device=dev)[:, ::2]  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        gm.group_max_keys(sig_t, tie, qw, num_bands=4, words=1, group=64, scale=512)
    planes = torch.ones((512, 6), dtype=torch.int8, device=dev)  # P % 4 != 0
    with pytest.raises(ValueError, match="P % 4"):
        gm.hamming_group_max_keys(planes, tie, planes[:3], group=64, scale=512)
    kw = dict(num_perm=128, group=64, scale=512)
    with pytest.raises(ValueError, match="contiguous"):
        gm.hamming_packed_group_max_keys(sig_t, tie, qw, **kw)
    with pytest.raises(ValueError, match="aligned"):
        gm.hamming_packed_group_max_keys(
            torch.zeros(4 * 512 + 1, dtype=torch.int32, device=dev)[1:].view(4, 512),
            tie, qw.contiguous()[:, :4].contiguous(), **kw,
        )
    with pytest.raises(ValueError, match="group in"):
        gm.hamming_packed_group_max_keys(sig_t, tie, qw.contiguous()[:, :4].contiguous(),
                                         **{**kw, "group": 8})


@pytest.mark.parametrize("engine", ["collision", "hamming"])
def test_lshrs_on_the_gpu_matches_the_cpu(engine, dev, rng):
    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host",
              seed=5, engine=engine)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((5000, 64)).astype(np.float32)
    for lo in range(0, 5000, 2000):
        gpu.index(np.arange(lo, min(lo + 2000, 5000)), X[lo : lo + 2000])
        cpu.index(np.arange(lo, min(lo + 2000, 5000)), X[lo : lo + 2000])
    Q = X[:300] + 0.3 * rng.standard_normal((300, 64)).astype(np.float32)
    b1, b2 = gm.group_max_keys.launches, gm.hamming_group_max_keys.launches
    out = gpu.serving_fn(top_k=10)(Q)
    launched = (gm.group_max_keys.launches - b1, gm.hamming_group_max_keys.launches - b2)
    assert launched == ((1, 0) if engine == "collision" else (0, 1))
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10)(Q))
    np.testing.assert_array_equal(gpu.serving_fn(top_k=1)(X[:300])[:, 0], np.arange(300))
    assert gpu.query_batch(Q, top_k=5) == cpu.query_batch(Q, top_k=5)


def test_packed_lshrs_on_the_gpu_matches_the_cpu_after_delete(dev, rng):
    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host",
              seed=6, engine="hamming", hamming_storage="packed")
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((5000, 64)).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(5000), X)
        lsh.delete(list(range(0, 5000, 50)))
    Q = X[:300] + 0.3 * rng.standard_normal((300, 64)).astype(np.float32)
    b2, b3 = gm.hamming_group_max_keys.launches, gm.hamming_packed_group_max_keys.launches
    out = gpu.serving_fn(top_k=10)(Q)
    assert gm.hamming_group_max_keys.launches == b2
    assert gm.hamming_packed_group_max_keys.launches == b3 + 1
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10)(Q))
    assert not np.isin(out, np.arange(0, 5000, 50)).any()
    assert gpu.query_hamming_batch(Q, top_k=5) == cpu.query_hamming_batch(Q, top_k=5)
    assert gpu._storage._planes is None
    assert gpu.compact() == cpu.compact() == 100
    np.testing.assert_array_equal(gpu.serving_fn(top_k=10)(Q), cpu.serving_fn(top_k=10)(Q))


@pytest.mark.parametrize("q", [256, 200])  # the gather path's slice, and a ragged one
def test_b1_kernel_matches_plain_at_a_million_slots(q, dev, rng):
    c, nb = 1 << 20, 16
    sig = rng.integers(0, 4, (nb, c), dtype=np.int32)
    q0 = rng.integers(0, 4, (q, nb), dtype=np.int32)
    q0[: q // 4] = sig[:, rng.integers(0, c, q // 4)].T
    sig_t, qwords = torch.from_numpy(sig).to(dev), torch.from_numpy(q0).to(dev)
    tie = _tie(rng, c, dev)
    kw = dict(num_bands=nb, words=1, group=64, scale=gm.key_scale(c))
    assert torch.equal(gm.group_max_keys(sig_t, tie, qwords, **kw),
                       gm.group_max_keys_ref(sig_t, tie, qwords, **kw))


def _graded_clusters(rng, clusters=150, members=20, dim=64):
    """Clusters whose member k is its centre plus noise orthogonal to it,
    of norm 0.05 * (k + 1) times the centre's: the cosine to the centre is
    exactly 1 / sqrt(1 + (0.05 (k + 1))**2), so neighbouring members differ
    by >= 3.7e-3 and an int8 payload's rounding (~1e-4) keeps them apart.
    Queries are centres moved by 0.2% of their norm."""
    c = rng.standard_normal((clusters, dim))
    noise = rng.standard_normal((clusters, members, dim))
    unit = c / np.linalg.norm(c, axis=1, keepdims=True)
    noise -= np.einsum("cmd,cd->cm", noise, unit)[..., None] * unit[:, None]
    noise /= np.linalg.norm(noise, axis=2, keepdims=True)
    steps = 0.05 * (1 + np.arange(members))
    X = c[:, None] + (steps[:, None] * noise) * np.linalg.norm(c, axis=1)[:, None, None]
    e = rng.standard_normal((100, dim))
    e *= 0.002 * np.linalg.norm(c[:100], axis=1, keepdims=True) / np.linalg.norm(e, axis=1,
                                                                                keepdims=True)
    return X.reshape(-1, dim).astype(np.float32), (c[:100] + e).astype(np.float32)


@pytest.mark.parametrize("payload_dtype", ["float32", "int8"])
@pytest.mark.parametrize("engine", ["full", "gather"])
def test_topp_on_the_gpu_matches_the_cpu(payload_dtype, engine, dev, rng):
    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host", seed=8,
              store_vectors=True, payload_dtype=payload_dtype, rerank_engine=engine)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X, Q = _graded_clusters(rng)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(len(X)), X)
        lsh.delete(list(range(0, len(X), 40)))
    b1 = gm.group_max_keys.launches
    ids, sims, n = gpu.serving_fn(top_k=10, mode="topp")(Q)
    assert gm.group_max_keys.launches - b1 == (1 if engine == "gather" else 0)
    want = cpu.serving_fn(top_k=10, mode="topp")(Q)
    valid = want[0] >= 0
    gaps = np.abs(np.diff(np.where(valid, want[1], np.nan), axis=1))[valid[:, 1:]]
    assert (gaps > 1e-5).all(), "near-tie in the compared cosines"
    np.testing.assert_array_equal(n, want[2])
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(sims[valid], want[1][valid], atol=1e-5)
    assert not np.isin(ids, np.arange(0, len(X), 40)).any()
    np.testing.assert_array_equal(gpu.serving_fn(top_k=1, mode="topp")(X[1:40])[0][:, 0],
                                  np.arange(1, 40))
    assert gpu.get_above_p_batch(Q[:8], p=0.5) == gpu.get_above_p_batch(Q[:8], p=0.5)
    g, c = gpu.get_above_p(Q[3], p=0.5), cpu.get_above_p(Q[3], p=0.5)
    assert [i for i, _ in g] == [i for i, _ in c]
    assert gpu.query(Q[3], top_k=None) == cpu.query(Q[3], top_k=None)


@pytest.mark.parametrize("payload_dtype", ["float32", "int8"])
def test_topp_past_4096_candidates_stays_on_the_gpu(payload_dtype, dev, rng, monkeypatch):
    """6,000 vectors fanned around one direction (cosines 1 - 2e-5 (k+1)),
    nearly all colliding with it: the default ``get_above_p`` (p=0.95) and
    a ``top_k`` past the first 4,096 reranked on the card equal the CPU
    store's, and no payload row is fetched to the host."""
    dim, n = 16, 6000
    u = rng.standard_normal(dim)
    u /= np.linalg.norm(u)
    v = rng.standard_normal((n, dim))
    v -= (v @ u)[:, None] * u
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cos = 1.0 - 2e-5 * (1 + np.arange(n))
    X = (cos[:, None] * u + np.sqrt(1.0 - cos**2)[:, None] * v).astype(np.float32)
    kw = dict(dim=dim, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host", seed=2,
              store_vectors=True, payload_dtype=payload_dtype)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(n), X)

    def refuse(ids):
        raise AssertionError("the resident payload left the card for a host rerank")

    monkeypatch.setattr(gpu._storage, "get_vectors", refuse)
    q = u.astype(np.float32)
    m = len(gpu.query(q, top_k=None))
    assert m == len(cpu.query(q, top_k=None)) and np.ceil(0.95 * m) > gpu._MAX_DEVICE_RERANK
    for got, want in ((gpu.get_above_p(q), cpu.get_above_p(q)),
                      (gpu.query(q, top_p=1.0, top_k=4500), cpu.query(q, top_p=1.0, top_k=4500))):
        assert len(got) == len(want) > 4096
        w = np.asarray([s for _, s in want])
        tied = np.zeros(len(w), bool)  # an int8 payload's rounding may tie neighbours
        tied[:-1] |= np.abs(np.diff(w)) <= 1e-5
        tied[1:] |= np.abs(np.diff(w)) <= 1e-5
        same = np.asarray([i for i, _ in got]) == np.asarray([i for i, _ in want])
        assert (same | tied).all()
        np.testing.assert_allclose([s for _, s in got], w, atol=1e-5)


def test_rerank_refuses_tf32(dev, rng):
    lsh = LSHRS(dim=32, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host",
                store_vectors=True, device=dev)
    X = rng.standard_normal((300, 32)).astype(np.float32)
    lsh.index(np.arange(300), X)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            lsh.get_above_p_batch(X[:4], p=0.5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
