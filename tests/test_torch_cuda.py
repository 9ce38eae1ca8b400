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
        (16, 1, 4096, 256, 4),  # four probes in one thread
        (32, 1, 4096, 256, 1),
        (32, 1, 4096, 256, 2),  # two probes, 32 words
        (32, 1, 4096, 100, 4),  # two lanes of two probes, ragged Q
        (16, 2, 4096, 70, 4),   # two-word bands, four probes
        (4, 3, 2048, 70, 1),    # three-word bands: generic
        (8, 1, 256, 9, 1),      # store smaller than one block's slot range
        (64, 1, 4096, 256, 1),  # 64 x 4 bands: two band lanes
        (64, 1, 4096, 100, 1),  # ragged Q
        (4, 2, 4096, 256, 1),   # 4 x 64 bands: two-word bands
        (32, 2, 4096, 100, 1),  # 32 bands of two words: two band lanes
        # the auto-tuner's bandings and the default index's multi-probe
        (48, 1, 4096, 256, 1),  # num_perm=384 at t=0.6: 48 x 8
        (48, 1, 4096, 100, 1),  # ragged Q
        (24, 1, 4096, 256, 1),  # num_perm=192 at t=0.7: 24 x 8
        (12, 1, 4096, 256, 1),  # num_perm=192 at t=0.5: 12 x 16
        (8, 1, 4096, 256, 2),   # LSHRS(multiprobe=2): 8 x 16
        (16, 1, 4096, 256, 3),  # 16 x 16 with multiprobe=3
        (32, 2, 4096, 256, 1),
        # probes split over lanes, and the generic instantiation
        (16, 1, 4096, 100, 8),  # two lanes of four probes
        (32, 1, 2048, 70, 6),   # two lanes of three probes
        (64, 1, 2048, 70, 3),   # two band lanes of three probes
        (6, 1, 2048, 70, 5),    # five lanes of one probe, two threads a warp idle
        (8, 1, 2048, 70, 9),    # three lanes of three probes
        (4, 3, 2048, 70, 2),    # three-word bands: generic, queries in shared memory
        (21, 3, 2048, 70, 16),  # three-word bands: generic, queries from global memory
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
    template = gm.group_max_keys.launches_by_template[bw, words, probes]
    got = gm.group_max_keys(sig_t, tie, qwords, **kw)
    assert gm.group_max_keys.launches == before + 1
    assert gm.group_max_keys.launches_by_template[bw, words, probes] == template + 1
    assert got.device == sig_t.device and got.shape == (q, c // 64)
    assert torch.equal(got, gm.group_max_keys_ref(sig_t, tie, qwords, **kw))


def test_b1_kernel_takes_more_queries_than_one_launch_holds(dev):
    """64 band words with 4 probes: four threads a query, 32 queries a block,
    so past 65,535 x 32 queries (grid.y's limit) the kernel launches twice."""
    num_bands, c, probes = 64, 64, 4
    q = 65535 * 32 + 70
    g = torch.Generator(device=dev).manual_seed(0)
    sig_t = torch.randint(0, 4, (num_bands, c), dtype=torch.int32, device=dev, generator=g)
    q0 = torch.randint(0, 4, (q, num_bands), dtype=torch.int32, device=dev, generator=g)
    planted = torch.arange(0, q, 3, device=dev)  # full matches, across both launches
    q0[planted] = sig_t[:, planted % c].T
    qwords = torch.cat([q0 ^ (1 << t) if t else q0 for t in range(probes)], 1).contiguous()
    tie = torch.arange(c - 1, -1, -1, dtype=torch.int32, device=dev)
    kw = dict(num_bands=num_bands, words=1, group=64, scale=gm.key_scale(c), probes=probes)
    got = gm.group_max_keys(sig_t, tie, qwords, **kw)
    assert got.shape == (q, 1)
    assert torch.equal(got, gm.group_max_keys_ref(sig_t, tie, qwords, **kw))


# asymmetric_shift(256, 2**20): the serving store's asymmetric packing.
_SHIFT_1M = 5


@pytest.mark.parametrize(
    "p,c,q,group,mode",
    [
        (256, 8192, 128, 64, "symmetric"),
        (256, 8192, 77, 64, "asymmetric"),       # the store's own shift
        (256, 8192, 513, 16, "asymmetric_5"),    # the 1M store's shift
        (256, 8192, 300, 128, "extremes"),       # dots at +-P * 127
        (32, 4096, 300, 32, "symmetric"),
        (30, 4096, 513, 16, "symmetric"),        # padded 30 -> 32
        (120, 4096, 1, 128, "asymmetric_0"),     # padded 120 -> 128, shift 0
        (64, 16000, 77, 16, "symmetric"),        # C not a multiple of the 256-slot tile
        (128, 192, 128, 64, "symmetric"),        # C smaller than one slot tile
        (128, 4096, 300, 32, "extremes"),
        (512, 4096, 513, 128, "asymmetric_5"),
        (512, 2048, 1, 64, "extremes"),
        (768, 2048, 70, 64, "symmetric"),        # past a resident slot tile: streamed
    ],
)
def test_b2_kernel_matches_plain(p, c, q, group, mode, dev, rng):
    """Kernel B2 bit for bit against its plain version: widths 30-768
    (padded to 32-column multiples), every group size, ragged Q, ~10% dead
    slots, symmetric and asymmetric packing, dots at the extremes."""
    from lshrs_tpu_torch.ops.hamming import plane_width

    width = plane_width(p)
    planes = np.zeros((c, width), np.int8)
    planes[:, :p] = 2 * rng.integers(0, 2, (c, p)) - 1
    qb = np.zeros((q, width), np.int8)
    if mode == "symmetric":
        qb[:, :p] = planes[rng.integers(0, c, q), :p]
        qb[q // 2 :, :p] *= np.where(rng.random((q - q // 2, p)) < 0.2, -1, 1).astype(np.int8)
        kw = {}
    else:
        qb[:, :p] = rng.integers(-127, 128, (q, p))
        shift = {"asymmetric": gm.asymmetric_shift(p, c), "asymmetric_0": 0,
                 "asymmetric_5": _SHIFT_1M, "extremes": _SHIFT_1M}[mode]
        kw = dict(offset=p * 127, shift=shift)
    if mode == "extremes":
        planes[0, :p], planes[1, :p] = 1, -1   # all-+1 and all--1 slots
        qb[0, :p] = 127
        qb[min(1, q - 1), :p] = -127
    planes_d = torch.from_numpy(planes).to(dev)
    qb_d = torch.from_numpy(qb).to(dev)
    tie = _tie(rng, c, dev)
    kw.update(group=group, scale=gm.key_scale(c), num_perm=p)
    before = gm.hamming_group_max_keys.launches
    got = gm.hamming_group_max_keys(planes_d, tie, qb_d, **kw)
    assert gm.hamming_group_max_keys.launches == before + 1
    assert got.device == planes_d.device and got.shape == (q, c // group)
    assert torch.equal(got, gm.hamming_group_max_keys_ref(planes_d, tie, qb_d, **kw))


@pytest.mark.parametrize(
    "bw,c,q,group,word_bits",
    [
        (16, 8192, 256, 64, 32),
        (16, 8192, 100, 16, 32),  # ragged Q
        (16, 4096, 300, 128, 32),  # Q past one block's 256 queries
        (8, 4096, 77, 32, 32),
        (12, 4096, 70, 64, 32),   # K = 384: one resident slot buffer
        (16, 256, 9, 64, 32),     # store smaller than one slot tile
        (16, 8192, 256, 64, 16),  # the 16 x 16 store's words: K = 256
        (32, 8192, 200, 64, 8),   # the 32 x 8 store's words: K = 256
        (10, 4096, 33, 16, 3),    # 10 x 3: 30 bits padded to 32 columns
        (32, 4096, 130, 64, 32),  # K = 1024: the streamed expansion
        (64, 2048, 70, 32, 32),   # K = 2048, the widest BW
        (16, 8192, 1, 64, 16),    # one query
        (16, 8192, 17, 64, 16),
    ],
)
def test_b3_kernel_matches_plain(bw, c, q, group, word_bits, dev, rng):
    # Words with word_bits random low bits (32: full words), so num_perm
    # = BW * word_bits; half the queries are stored slots with ~10% of
    # their bits flipped.
    mask = (1 << word_bits) - 1
    sig = (rng.integers(0, 2**32, (bw, c), dtype=np.uint64) & mask).astype(np.uint32).view(np.int32)
    qw = (rng.integers(0, 2**32, (q, bw), dtype=np.uint64) & mask).astype(np.uint32).view(np.int32)
    flips = np.where(rng.random((q // 2, bw, 32)) < 0.1, 1, 0) << np.arange(32)
    flips = (flips.sum(-1) & mask).astype(np.uint32).view(np.int32)
    qw[: q // 2] = sig[:, rng.integers(0, c, q // 2)].T ^ flips
    sig_t = torch.from_numpy(np.ascontiguousarray(sig)).to(dev)
    qwords = torch.from_numpy(np.ascontiguousarray(qw)).to(dev)
    tie = _tie(rng, c, dev)
    kw = dict(num_perm=bw * word_bits, group=group, scale=gm.key_scale(c), word_bits=word_bits)
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
    planes = torch.ones((512, 24), dtype=torch.int8, device=dev)  # 24-byte rows
    with pytest.raises(ValueError, match="multiple of 16"):
        gm.hamming_group_max_keys(planes, tie, planes[:3], group=64, scale=512)
    planes = torch.ones((512 * 32 + 1,), dtype=torch.int8, device=dev)[1:].view(512, 32)
    with pytest.raises(ValueError, match="aligned"):
        gm.hamming_group_max_keys(planes, tie, planes[:3].contiguous(), group=64, scale=512)
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


def test_lshrs_at_30_bits_on_the_gpu_matches_the_cpu(dev, rng):
    """num_perm = 30 on the Hamming engine: the card's padded bitplanes
    (32 columns) through kernel B2 give the CPU store's ids."""
    kw = dict(dim=32, num_perm=30, num_bands=10, rows_per_band=3, hash_mode="host",
              seed=7, engine="hamming")
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((3000, 32)).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(3000), X)
    Q = X[:200] + 0.3 * rng.standard_normal((200, 32)).astype(np.float32)
    b2 = gm.hamming_group_max_keys.launches
    out = gpu.serving_fn(top_k=10)(Q)
    assert gm.hamming_group_max_keys.launches == b2 + 1
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10)(Q))
    assert gpu.query_hamming_batch(Q, top_k=5) == cpu.query_hamming_batch(Q, top_k=5)
    assert gpu._storage._planes.shape[1] == 32
    assert gpu.stats()["index"]["hamming_plane_bytes"] == cpu.stats()["index"]["hamming_plane_bytes"]


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


# ---------------------------------------------------------------------------
# hash families, multi-probe and where= filters on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,nb,r", [("structured", 16, 16), ("crosspolytope", 32, 8)])
def test_fwht_families_hash_identically_on_the_card(family, nb, r, dev, rng):
    """CUDA words == host words (native C FWHT), probe words too: the
    butterfly order is fixed, so the card's float32 sums are the host's."""
    from lshrs_tpu_torch.hash.hasher import LSHHasher
    from lshrs_tpu_torch.native import load_fwht_library, native_status
    from lshrs_tpu_torch.ops.bitpack import words_to_numpy

    assert load_fwht_library() is not None, native_status()
    h = LSHHasher(nb, r, 768, seed=3, hash_family=family, device=dev)
    x = rng.standard_normal((2048, 768)).astype(np.float32)
    x[:64] = rng.integers(-2, 3, (64, 768))  # exact magnitude ties
    np.testing.assert_array_equal(words_to_numpy(h.hash_batch_words(x)), h.hash_batch_words_host(x))
    np.testing.assert_array_equal(
        words_to_numpy(h.hash_batch_probe_words(x, 4)), h.hash_batch_probe_words_host(x, 4)
    )


@pytest.mark.parametrize("engine,storage,kernel", [
    ("collision", None, "group_max_keys"),
    ("hamming", "planes", "hamming_group_max_keys"),
    ("hamming", "packed", "hamming_packed_group_max_keys"),
])
def test_filtered_lshrs_on_the_gpu_matches_the_cpu(engine, storage, kernel, dev, rng):
    from lshrs_tpu_torch import IdFilter

    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host",
              seed=5, engine=engine, hamming_storage=storage, hash_family="structured")
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((5000, 64)).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(5000), X)
    Q = X[:300] + 0.3 * rng.standard_normal((300, 64)).astype(np.float32)
    f = IdFilter(allowed_ids=np.arange(0, 5000, 3), disallowed_ids=np.arange(0, 5000, 7))
    fn = getattr(gm, kernel)
    before = fn.launches
    out = gpu.serving_fn(top_k=10, where=f)(Q)
    assert fn.launches == before + 1
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10, where=f)(Q))
    assert f.admits(out[out >= 0]).all() and (out >= 0).any()
    assert engine == "collision" or (out >= 0).all()  # Hamming ranks every admitted slot
    state = f.device_state(gpu._storage)
    assert state[0].is_cuda
    assert gpu.query_batch(Q, top_k=5, where=f) == cpu.query_batch(Q, top_k=5, where=f)
    assert f.device_state(gpu._storage)[0] is state[0]  # reused by the second query


@pytest.mark.parametrize("family,nb,r,probes", [
    ("gaussian", 16, 16, 2), ("structured", 16, 16, 4), ("crosspolytope", 32, 8, 4),
])
def test_multiprobe_lshrs_on_the_gpu_matches_the_cpu(family, nb, r, probes, dev, rng):
    kw = dict(dim=64, num_perm=256, num_bands=nb, rows_per_band=r, hash_mode="host", seed=5,
              engine="collision", hash_family=family, multiprobe=probes, store_vectors=True,
              payload_dtype="int8", rerank_engine="gather", rerank_candidates=256)
    if family == "crosspolytope":
        kw.update(dim=128)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((5000, kw["dim"])).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(5000), X)
    Q = X[:300] + 0.3 * rng.standard_normal((300, kw["dim"])).astype(np.float32)
    before = gm.group_max_keys.launches
    out = gpu.serving_fn(top_k=10)(Q)
    assert gm.group_max_keys.launches == before + 1
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10)(Q))
    assert gpu.query_batch(Q, top_k=5) == cpu.query_batch(Q, top_k=5)
    ids_g, sims_g, n_g = gpu.serving_fn(top_k=5, mode="topp", batch_hint=300)(Q)
    ids_c, sims_c, n_c = cpu.serving_fn(top_k=5, mode="topp", batch_hint=300)(Q)
    np.testing.assert_array_equal(n_g, n_c)
    np.testing.assert_array_equal(ids_g, ids_c)
    np.testing.assert_allclose(sims_g[ids_c >= 0], sims_c[ids_c >= 0], atol=1e-5)


@pytest.mark.parametrize("p,c,q,group,wire", [
    (256, 8192, 513, 64, "int8_1m"),     # offset 32512, shift 5: asymmetric at 2**20 slots
    (256, 8192, 300, 64, "int4_1m"),     # offset 1792, shift 1: the int4 wire at 2**20 slots
    (128, 8192, 513, 64, "coarse"),      # the cascade's coarse pass, tie shift 0
    (128, 8192, 77, 16, "coarse_shifted"),  # coarse scale and tie of a 2**24-slot store
])
def test_b2_kernel_matches_plain_on_asymmetric_and_cascade_keys(p, c, q, group, wire, dev, rng):
    """Kernel B2 bit for bit against its plain version at the key packings
    the asymmetric and cascade paths give it."""
    from lshrs_tpu_torch.ops.hamming import cascade_coarse_scale

    planes = (2 * rng.integers(0, 2, (c, p)) - 1).astype(np.int8)
    tie = _tie(rng, c, dev)
    kw = dict(group=group, num_perm=p, scale=gm.key_scale(c))
    if wire == "int8_1m":
        qb = rng.integers(-127, 128, (q, p)).astype(np.int8)
        qb[0], qb[1] = 127, -127
        kw.update(offset=p * 127, shift=gm.asymmetric_shift(p, 1 << 20))
        assert kw["offset"] == 32512 and kw["shift"] == 5
    elif wire == "int4_1m":
        qb = rng.integers(-7, 8, (q, p)).astype(np.int8)
        kw.update(offset=p * 7, shift=gm.asymmetric_shift(p, 1 << 20, qmax=7))
        assert kw["offset"] == 1792 and kw["shift"] == 1
    else:
        qb = planes[rng.integers(0, c, q)].copy()
        qb[q // 2 :] *= np.where(rng.random((q - q // 2, p)) < 0.3, -1, 1).astype(np.int8)
        scale, tie_shift = cascade_coarse_scale(p, 1 << 24 if wire == "coarse_shifted" else c)
        assert tie_shift == (1 if wire == "coarse_shifted" else 0)
        tie = torch.where(tie >= 0, tie >> tie_shift, tie)
        kw.update(scale=scale)
    planes_d, qb_d = torch.from_numpy(planes).to(dev), torch.from_numpy(qb).to(dev)
    packing = (p, kw.get("offset", p), kw.get("shift", 1))  # (width, offset, shift)
    before = gm.hamming_group_max_keys.launches
    before_packing = gm.hamming_group_max_keys.launches_by_packing[packing]
    got = gm.hamming_group_max_keys(planes_d, tie, qb_d, **kw)
    assert gm.hamming_group_max_keys.launches == before + 1
    assert gm.hamming_group_max_keys.launches_by_packing[packing] == before_packing + 1
    assert torch.equal(got, gm.hamming_group_max_keys_ref(planes_d, tie, qb_d, **kw))


@pytest.mark.parametrize("coords_wire", ["int8", "int4"])
def test_asymmetric_lshrs_on_the_gpu_matches_the_cpu(coords_wire, dev, rng):
    from lshrs_tpu_torch import IdFilter

    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host", seed=5,
              engine="hamming")
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((5000, 64)).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(5000), X)
        lsh.delete(list(range(0, 5000, 40)))
    Q = X[:300] + 0.3 * rng.standard_normal((300, 64)).astype(np.float32)
    before = gm.hamming_group_max_keys.launches
    out = gpu.serving_fn(top_k=10, mode="asymmetric", coords_wire=coords_wire)(Q)
    assert gm.hamming_group_max_keys.launches == before + 1
    np.testing.assert_array_equal(
        out, cpu.serving_fn(top_k=10, mode="asymmetric", coords_wire=coords_wire)(Q))
    assert not np.isin(out, np.arange(0, 5000, 40)).any()
    f = IdFilter(allowed_ids=np.arange(0, 5000, 3))
    assert gpu.query_asymmetric_batch(Q, top_k=5, where=f) == (
        cpu.query_asymmetric_batch(Q, top_k=5, where=f))


def test_cascade_lshrs_on_the_gpu_matches_the_cpu(dev, rng):
    from lshrs_tpu_torch import IdFilter

    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host", seed=5,
              engine="hamming", hamming_cascade=128, hamming_cascade_refine=1024)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((6000, 64)).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(6000), X)
        lsh.delete(list(range(0, 6000, 30)))
    Q = X[:300] + 0.3 * rng.standard_normal((300, 64)).astype(np.float32)
    before = gm.hamming_group_max_keys.launches
    out = gpu.serving_fn(top_k=10)(Q)
    assert gm.hamming_group_max_keys.launches == before + 1
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10)(Q))
    assert gpu._storage._planes.shape[1] == 128
    f = IdFilter(allowed_ids=np.arange(0, 6000, 4))
    assert gpu.query_hamming_batch(Q, top_k=5, where=f) == cpu.query_hamming_batch(Q, top_k=5,
                                                                                     where=f)


@pytest.mark.parametrize("payload_dtype", ["float32", "int8"])
def test_structured_rehash_on_the_gpu_matches_the_cpu(payload_dtype, dev, rng):
    """A structured rehash on the card (16 x 16 -> 32 x 8) rebuilds the
    CPU copy's words bit for bit (the FWHT order is fixed), then serves
    the same top-k through B1 at 32 band words and the same top-p."""
    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_family="structured",
              seed=3, engine="collision", store_vectors=True, payload_dtype=payload_dtype)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((5000, 64)).astype(np.float32)
    for lsh in (gpu, cpu):
        lsh.index(np.arange(5000), X)
        lsh.delete(list(range(0, 5000, 45)))
        lsh.rehash(num_bands=32, rows_per_band=8, seed=11)
    assert torch.equal(gpu._storage._sig_rows.cpu(), cpu._storage._sig_rows)
    Q = X[:300] + 0.3 * rng.standard_normal((300, 64)).astype(np.float32)
    gm.group_max_keys.launches_by_shape.clear()
    out = gpu.serving_fn(top_k=10)(Q)
    assert gm.group_max_keys.launches_by_shape.get((32, 1), 0) == 1
    np.testing.assert_array_equal(out, cpu.serving_fn(top_k=10)(Q))
    ti, ts, tn = gpu.serving_fn(top_k=10, mode="topp")(Q)
    ci, cs, cn = cpu.serving_fn(top_k=10, mode="topp")(Q)
    np.testing.assert_array_equal(tn, cn)
    np.testing.assert_allclose(ts, cs, atol=1e-5)
    assert (ti == ci).mean() > 0.99  # swaps only between cosines within 1e-5


def test_bucketed_lshrs_on_the_gpu_matches_the_cpu(dev, rng):
    """query_mode="bucket" on the card: ids, counts and overflow counts of
    a CPU copy, a truncating bucket_cap included; the scan (B1) answers
    the serving closure and filtered queries."""
    from lshrs_tpu_torch import IdFilter

    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host", seed=9,
              engine="collision", query_mode="bucket", bucket_cap=4)
    gpu, cpu = LSHRS(device=dev, **kw), LSHRS(device="cpu", **kw)
    X = rng.standard_normal((6000, 64)).astype(np.float32)
    X[5000:] = X[:1000]  # duplicates make runs past the window
    for lsh in (gpu, cpu):
        lsh.index(np.arange(6000), X)
        lsh.delete(list(range(0, 6000, 35)))
    Q = np.concatenate([X[:300], rng.standard_normal((300, 64)).astype(np.float32)])
    before = gm.group_max_keys.launches
    assert gpu.query_batch(Q, top_k=10) == cpu.query_batch(Q, top_k=10)
    assert gm.group_max_keys.launches == before  # the bucket engine runs no kernel
    g, c = gpu.stats()["index"], cpu.stats()["index"]
    assert g["bucket_overflows"] == c["bucket_overflows"] > 0
    np.testing.assert_array_equal(gpu.serving_fn(top_k=10)(Q), cpu.serving_fn(top_k=10)(Q))
    assert gm.group_max_keys.launches == before + 1
    f = IdFilter(allowed_ids=np.arange(0, 6000, 3))
    assert gpu.query_batch(Q, top_k=5, where=f) == cpu.query_batch(Q, top_k=5, where=f)


@pytest.mark.parametrize("hash_mode", ["device", "host"])
@pytest.mark.parametrize("cpus", [1, 4], ids=["serial", "pipelined"])
def test_create_signatures_on_the_gpu_equals_index(hash_mode, cpus, dev, rng, monkeypatch):
    """create_signatures (prefetch thread, and the two-stage pipeline whose
    worker does host work only) builds the store that index() builds from
    the same batches, bit for bit, on the card; its serving launches B1."""
    import os

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, hash_mode=hash_mode, seed=3,
              store_vectors=True)
    a, b = LSHRS(device=dev, **kw), LSHRS(device=dev, **kw)
    X = rng.standard_normal((5000, 64)).astype(np.float32)
    ids = 7 * np.arange(5000) + 3
    a.create_signatures(format="numpy", vectors=X, indices=ids, batch_size=1024, prefetch=2)
    for lo in range(0, 5000, 1024):
        b.index(ids[lo : lo + 1024], X[lo : lo + 1024])
    sa, sb = a._storage.state_arrays(), b._storage.state_arrays()
    assert set(sa) == set(sb)
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])
    assert a._storage.device.type == "cuda" and a.stats()["counters"] == b.stats()["counters"]
    before = gm.group_max_keys.launches
    out = a.serving_fn(top_k=10)(X[:512])
    assert gm.group_max_keys.launches > before
    np.testing.assert_array_equal(out[:, 0], ids[:512])


def test_memory_backend_equals_its_device_twin_on_the_gpu(dev, rng):
    """backend="memory" (host hash, host buckets) against a device index on
    the card with the same host words (hash_mode="host", collision, B1)."""
    kw = dict(dim=64, num_perm=256, num_bands=16, rows_per_band=16, seed=5)
    X = rng.standard_normal((3000, 64)).astype(np.float32)
    mem = LSHRS(backend="memory", vector_fetch_fn=lambda i: X[list(i)], **kw)
    twin = LSHRS(hash_mode="host", engine="collision", vector_fetch_fn=lambda i: X[list(i)],
                 device=dev, **kw)
    for lsh in (mem, twin):
        lsh.index(np.arange(3000), X)
    assert twin._storage.device.type == "cuda" and mem.stats()["device"] is None
    # One query at a time on both sides: each hashes a single row (the
    # memory backend's query_batch is a per-vector loop; the twin's hashes
    # the batch in one sgemm, which may round a near-zero coordinate apart).
    Q = np.concatenate([X[:20], rng.standard_normal((20, 64)).astype(np.float32)])
    before = gm.group_max_keys.launches
    assert mem.query_batch(Q, top_k=10) == [twin.query(q, top_k=10) for q in Q]
    assert gm.group_max_keys.launches > before
    for q in Q[:8]:
        assert mem.query(q, top_k=None) == twin.query(q, top_k=None)
        assert mem.query(q, top_p=0.5) == twin.query(q, top_p=0.5)
    mem.delete(list(range(0, 3000, 7)))
    twin.delete(list(range(0, 3000, 7)))
    assert mem.query_batch(Q, top_k=10) == [twin.query(q, top_k=10) for q in Q]


@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_sharded_store_on_one_card_matches_unsharded(storage, dev, rng):
    """Four shards on one card (the mesh repeats cuda:0) == the unsharded
    store on B1, and on B2 (planes) or B3 (packed): each kernel launched
    once per shard per batch on the shard's contiguous block."""
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh

    kw = dict(num_bands=16, rows_per_band=16, initial_capacity=8192, enable_hamming=True,
              hamming_storage=storage)
    sharded = ShardedDeviceStore(mesh=make_mesh(devices=[dev] * 4), **kw)
    single, cpu = DeviceStore(device=dev, **kw), DeviceStore(device="cpu", **kw)
    lsh = LSHRS(dim=64, num_perm=256, num_bands=16, rows_per_band=16, seed=3, device="cpu")
    X = rng.standard_normal((7000, 64)).astype(np.float32)
    words = lsh._hasher.hash_batch_words_host(X)
    for s in (sharded, single, cpu):
        s.add_signature_batch(np.arange(7000), words)
        s.remove_indices(list(range(0, 7000, 50)))
    qw = words[:300]
    b1, hk = gm.group_max_keys, (gm.hamming_group_max_keys if storage == "planes"
                                 else gm.hamming_packed_group_max_keys)
    before = b1.launches, hk.launches
    got_c, got_h = sharded.query_topk(qw, 10), sharded.query_hamming(qw, 10)
    assert (b1.launches - before[0], hk.launches - before[1]) == (4, 4)
    for want in (single, cpu):
        for a, b in zip(got_c + got_h, want.query_topk(qw, 10) + want.query_hamming(qw, 10)):
            np.testing.assert_array_equal(a, b)
    assert all(s._sig_t.device.type == "cuda" and s._sig_t.is_contiguous() for s in sharded._shards)


def test_kernels_refuse_a_strided_shard_view(dev, rng):
    """A shard taken as a column slice of one global (BW, C) tensor is a
    strided view: the CUDA wrappers raise (the plain versions would not),
    which is why each shard owns contiguous tensors."""
    c, bw = 8192, 16
    sig_t = torch.from_numpy(rng.integers(0, 4, (bw, c), dtype=np.int32)).to(dev)
    tie = _tie(rng, c // 4, dev)
    qw = sig_t[:, :64].T.contiguous()
    view = sig_t[:, c // 4 : c // 2]
    assert not view.is_contiguous()
    kw = dict(group=64, scale=gm.key_scale(c // 4))
    with pytest.raises(ValueError, match="contiguous"):
        gm.group_max_keys(view, tie, qw, num_bands=bw, words=1, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        gm.hamming_packed_group_max_keys(view, tie, qw, num_perm=32 * bw, **kw)
    planes = torch.ones((c, 512), dtype=torch.int8, device=dev)[:, :256]
    with pytest.raises(ValueError, match="contiguous"):
        gm.hamming_group_max_keys(planes[: c // 4], tie, planes[:8].contiguous(), num_perm=256, **kw)
    # the same block made contiguous launches and equals the plain version
    block = view.contiguous()
    np.testing.assert_array_equal(
        gm.group_max_keys(block, tie, qw, num_bands=bw, words=1, **kw).cpu().numpy(),
        gm.group_max_keys_ref(block, tie, qw, num_bands=bw, words=1, **kw).cpu().numpy(),
    )


@pytest.mark.parametrize("q", [1, 17, 512])
def test_chunked_hamming_core_on_the_gpu_matches_the_cpu_and_b2(q, dev, rng):
    """The chunked Hamming cores (one ``torch._int_mm`` per step, its query
    rows padded past 16) on the card == the same cores on the CPU, and ==
    the grouped B2 engine at 2^16 slots (below the ceiling both apply)."""
    from lshrs_tpu_torch.ops import hamming as ham
    from lshrs_tpu_torch.ops.scan import compute_chunk_ranks

    c, nb, r, chunk = 1 << 16, 16, 16, 2048
    words = rng.integers(0, 2**r, (c, nb), dtype=np.uint32)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.1] = -1
    flips = (rng.random((q, nb)) < 0.2).astype(np.uint32) << rng.integers(0, r, (q, nb)).astype(np.uint32)
    qw = words[rng.integers(0, c, q)] ^ flips

    def run(device):
        w = torch.from_numpy(words.view(np.int32)).to(device)
        qwt = torch.from_numpy(qw.view(np.int32)).to(device)
        idt = torch.from_numpy(ids).to(device)
        planes = ham.unpack_bitplanes(w, num_bands=nb, rows_per_band=r, width=ham.plane_width(nb * r))
        qbits = ham.unpack_bitplanes(qwt, num_bands=nb, rows_per_band=r, width=ham.plane_width(nb * r))
        ranks = compute_chunk_ranks(idt, chunk=chunk)
        sig_t = w.T.contiguous()
        out = [
            ham.hamming_topk_chunked_core(planes, idt, ranks, qbits, k=10, chunk=chunk, num_perm=nb * r),
            ham.hamming_topk_packed_chunked_core(sig_t, idt, ranks, qwt, num_perm=nb * r, k=10, chunk=chunk),
        ]
        if device != "cpu":
            out.append(ham.hamming_topk_core(
                planes, global_tie_core(idt), qbits, qwt, None, k=10, group=64,
                num_perm=nb * r, sig_t=sig_t, ids=idt,
            ))
        return [tuple(t.cpu().numpy() for t in pair) for pair in out]

    cpu, gpu = run("cpu"), run(dev)
    for got in gpu:
        for a, b in zip(cpu[0], got):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cpu[1][0], cpu[0][0])


def test_b2_over_the_live_prefix_on_the_gpu(dev, rng, monkeypatch):
    """A 2^20-slot store filled to 590,000 (a live prefix ending inside a
    256-slot tile) at Q=10,000: B2's group maxima over the prefix are the
    full launch's first columns bit for bit, and the store's ids and
    distances equal its full-capacity path's."""
    from lshrs_tpu_torch.ops import hamming as th
    from lshrs_tpu_torch.storage.device import DeviceStore

    n, q, cap = 590_000, 10_000, 1 << 20
    store = DeviceStore(num_bands=16, rows_per_band=16, dim=64, initial_capacity=cap,
                        enable_hamming=True, device=dev)
    words = rng.integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    store.add_signature_batch(rng.permutation(4 * n)[:n], words)
    store.remove_indices(store.state_arrays()["ids"][::97].tolist())
    qw = words[rng.integers(0, n, q)] ^ rng.integers(0, 1 << 16, (q, 16), dtype=np.uint32) & 0x0101

    scored, b2 = [], th.hamming_group_max_keys
    with monkeypatch.context() as mp:
        mp.setattr(th, "hamming_group_max_keys",
                   lambda planes, *a, **kw: scored.append(planes.shape[0]) or b2(planes, *a, **kw))
        hamming, ids = store.query_hamming(qw, 10)
    live, group = store._live_slots(), store._group()
    assert store._capacity == cap and live == 590_016 and live % 256
    assert scored == [live]  # one launch over the live prefix: cap - live slots skipped

    qbits = store._planes_rows(torch.from_numpy(qw.view(np.int32)).to(dev))
    kw = dict(group=group, scale=gm.key_scale(cap), num_perm=256)
    full = gm.hamming_group_max_keys(store._planes, store._tie, qbits, **kw)
    prefix = gm.hamming_group_max_keys(store._planes[:live], store._tie[:live], qbits, **kw)
    assert torch.equal(prefix, full[:, : live // group])
    del full, prefix

    before = gm.hamming_group_max_keys.launches
    monkeypatch.setattr(store, "_live_slots", lambda: cap)
    full_hamming, full_ids = store.query_hamming(qw, 10)
    assert gm.hamming_group_max_keys.launches == before + 1
    np.testing.assert_array_equal(ids, full_ids)
    np.testing.assert_array_equal(hamming, full_hamming)
    assert (ids[:, 0] >= 0).all()


def test_blocked_hamming_past_the_key_ceiling_on_the_gpu(dev, rng, monkeypatch):
    """A 2^23-slot store of 4,500,000 random signatures, past one B2
    launch's int32 key (2^22 slots at 256 bits), at Q=256: B2 runs once
    per 2^22-slot block (twice, the second block 305,728 live slots), no
    chunked core runs, and the ids and distances equal the store's
    chunked route's, unfiltered and under ``where=``."""
    import lshrs_tpu_torch.storage.device as device_mod
    from lshrs_tpu_torch.storage.device import DeviceStore
    from lshrs_tpu_torch.storage.filter import IdFilter

    n, q = 4_500_000, 256
    store = DeviceStore(num_bands=16, rows_per_band=16, initial_capacity=1 << 23,
                        enable_hamming=True, device=dev)
    words = rng.integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    ids = rng.permutation(2 * n)[:n]
    store.add_signature_batch(ids, words)
    store.remove_indices(ids[::101].tolist())
    qw = words[rng.integers(0, n, q)] ^ rng.integers(0, 1 << 16, (q, 16), dtype=np.uint32) & 0x0101
    allow = IdFilter(allowed_ids=ids[::3])

    before = gm.hamming_group_max_keys.launches
    got = [store.query_hamming(qw, 10), store.query_hamming(qw, 10, where=allow)]
    assert gm.hamming_group_max_keys.launches - before == 4
    assert store._capacity == 1 << 23 and store._ranks is None
    assert store._live_slots() - (1 << 22) == 305_728
    with monkeypatch.context() as mp:
        mp.setattr(device_mod, "hamming_block_slots", lambda p: 1 << 40)
        mp.setattr(device_mod, "supports_hamming_grouped", lambda *a: False)
        want = [store.query_hamming(qw, 10), store.query_hamming(qw, 10, where=allow)]
    assert gm.hamming_group_max_keys.launches - before == 4
    for (gh, gi), (wh, wi) in zip(got, want):
        np.testing.assert_array_equal(gh, wh)
        np.testing.assert_array_equal(gi, wi)
    store.close()
