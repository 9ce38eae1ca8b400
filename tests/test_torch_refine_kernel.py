"""Kernel ``hamming_refine_topk`` (``csrc/hamming_refine_topk.cu``) on a GPU.

Every test here needs an NVIDIA GPU and skips elsewhere (marker ``cuda``;
the check is made in a fixture). The file imports torch, NumPy and the
port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_refine_kernel.py

The kernel is held to its plain version (``hamming_refine_topk_ref``, the
three-stage tail it replaces) bit for bit, hamming and ids, on grouped
refine tables drawn here, and an ``LSHRS`` past 2^22 slots to the same
store's plain tail.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lshrs_tpu_torch.ops import hamming as th
from lshrs_tpu_torch.ops.scan import build_grouped_refine_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (hamming_refine_topk has no CPU build)")
    return torch.device("cuda")


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


def _case(rng, dev, *, q, nw, group, m, n_groups, word_bits=32, tie_bits=21, dead=0.05):
    """A grouped refine table of ``n_groups`` groups (words of ``word_bits``
    low bits, distinct ids, ties ``2^tie_bits - 1 - rank`` of a random subset
    of ranks in id order, a ``dead`` share at -1, half of those with id -1),
    queries near stored slots and ``m`` distinct groups a query."""
    c = n_groups * group
    words = rng.integers(0, 1 << word_bits, (c, nw), dtype=np.uint64).astype(np.uint32)
    ids = rng.permutation(4 * c)[:c].astype(np.int64)
    ranks = np.sort(rng.choice(1 << tie_bits, c, replace=False))
    tie = np.empty(c, np.int64)
    tie[np.argsort(ids)] = (1 << tie_bits) - 1 - ranks
    gone = rng.random(c) < dead
    tie[gone] = -1
    ids[gone & (rng.random(c) < 0.5)] = -1
    ext = np.concatenate([words.view(np.int32), tie[:, None], ids[:, None]], axis=1)
    rows = build_grouped_refine_rows(torch.from_numpy(ext.astype(np.int32)), group=group)
    top = np.argsort(rng.random((q, n_groups)), axis=1)[:, :m]
    near = words[top[:, 0] * group + rng.integers(0, group, q)]
    noise = rng.integers(0, 1 << word_bits, (3, q, nw), dtype=np.uint64).astype(np.uint32)
    qcmp = near ^ (noise[0] & noise[1] & noise[2])  # each bit flipped at 1/8
    return (torch.from_numpy(qcmp.view(np.int32)).to(dev), rows.to(dev),
            torch.from_numpy(top.astype(np.int64)).to(dev))


def _same(qcmp, rows, top, *, group, p, k, scale):
    before = th.hamming_refine_topk.launches
    got = th.hamming_refine_topk(qcmp, rows, top, group=group, p=p, k=k, scale=scale)
    torch.cuda.synchronize()
    assert th.hamming_refine_topk.launches == before + 1
    want = th.hamming_refine_topk_ref(qcmp, rows, top, group=group, p=p, k=k, scale=scale)
    assert torch.equal(got[0], want[0]), "hamming differs from the plain tail"
    assert torch.equal(got[1], want[1]), "ids differ from the plain tail"
    return got


@pytest.mark.parametrize("q,nw,word_bits,group,m,k,tie_bits,dead", [
    (10_000, 8, 32, 64, 10, 10, 21, 0.05),  # the cells' shape: narrow r = 16, C = 2^21
    (2_000, 16, 16, 64, 10, 10, 21, 0.05),  # word-aligned: BW = 16 words of 16 bits
    (2_000, 8, 32, 64, 10, 10, 23, 0.05),   # wide keys: global ties at C = 2^23's scale
    (700, 8, 32, 32, 1, 1, 20, 0.05),       # k = 1
    (300, 8, 32, 64, 100, 100, 21, 0.05),   # k = 100 (ann-benchmarks), 6,400 candidates
    (100, 8, 32, 128, 64, 128, 22, 0.05),   # m * group at the 8,192 limit, k at 128
    (100, 8, 32, 16, 512, 10, 20, 0.05),    # the limit at group 16
    (500, 8, 32, 16, 10, 10, 20, 0.05),     # group 16
    (500, 8, 32, 32, 10, 10, 20, 0.05),     # group 32
    (500, 8, 32, 128, 10, 10, 20, 0.05),    # group 128
    (300, 64, 32, 32, 10, 10, 20, 0.05),    # nw = 64
    (300, 1, 8, 16, 4, 10, 20, 0.05),       # nw = 1 of 8 bits: few distances
    (300, 33, 32, 64, 3, 7, 20, 0.05),      # odd nw and k
    (1_000, 8, 2, 64, 10, 10, 21, 0.05),    # 16 bits a slot: equal distances everywhere
    (300, 8, 32, 64, 10, 10, 21, 0.9),      # mostly dead and tombstoned slots
    (200, 8, 32, 64, 10, 10, 21, 1.0),      # every slot dead: all padding
    (300, 8, 32, 16, 1, 100, 20, 0.05),     # k > m * group: the tail padded
])
def test_refine_kernel_matches_plain(q, nw, word_bits, group, m, k, tie_bits, dead, dev, rng):
    n_groups = max(2 * m, 4096 // group)
    qcmp, rows, top = _case(rng, dev, q=q, nw=nw, group=group, m=m, n_groups=n_groups,
                            word_bits=word_bits, tie_bits=tie_bits, dead=dead)
    _same(qcmp, rows, top, group=group, p=nw * word_bits, k=k, scale=1 << tie_bits)


def test_refine_kernel_orders_by_hamming_then_id(dev, rng):
    """Equal distances go to the smaller id, whatever the groups' order:
    the answer equals a NumPy sort of every candidate."""
    group, m, k, nw = 64, 10, 40, 8
    qcmp, rows, top = _case(rng, dev, q=200, nw=nw, group=group, m=m, n_groups=512,
                            word_bits=2, dead=0.2)
    h, ids = _same(qcmp, rows, top, group=group, p=16, k=k, scale=1 << 21)
    rows_h, top_h, q_h = rows.cpu().numpy(), top.cpu().numpy(), qcmp.cpu().numpy()
    for i in range(0, 200, 37):
        cand = rows_h[top_h[i]].reshape(m, nw + 2, group)
        words, tie, cid = cand[:, :nw], cand[:, nw].ravel(), cand[:, nw + 1].ravel()
        dist = np.unpackbits((words ^ q_h[i][None, :, None]).view(np.uint8), axis=None)
        dist = dist.reshape(m, nw, group, 32).sum(axis=(1, 3)).ravel()
        alive = tie >= 0
        order = np.lexsort((cid[alive], dist[alive]))[:k]
        want_ids = np.full(k, -1)
        want_h = np.full(k, 17)
        want_ids[: order.size] = cid[alive][order]
        want_h[: order.size] = dist[alive][order]
        np.testing.assert_array_equal(ids[i].cpu().numpy(), want_ids)
        np.testing.assert_array_equal(h[i].cpu().numpy(), want_h)


def test_refine_kernel_on_a_block_of_the_table(dev, rng):
    """The blocked route hands each block its rows of the store's table (a
    view at a row offset) with global ties at C = 2^23's scale."""
    group, m = 64, 10
    qcmp, rows, top = _case(rng, dev, q=1_000, nw=8, group=group, m=m, n_groups=4096,
                            tie_bits=23)
    block = rows[1024:3072]
    top = torch.from_numpy(np.argsort(rng.random((1_000, 2048)), axis=1)[:, :m]).to(dev)
    _same(qcmp, block, top, group=group, p=256, k=10, scale=1 << 23)


def test_refine_kernel_takes_no_queries_and_refuses_what_it_cannot(dev, rng):
    qcmp, rows, top = _case(rng, dev, q=64, nw=8, group=64, m=10, n_groups=128)
    kw = dict(group=64, p=256, k=10, scale=1 << 21)
    h, ids = th.hamming_refine_topk(qcmp[:0], rows, top[:0], **kw)
    assert h.shape == ids.shape == (0, 10)
    with pytest.raises(ValueError, match="contiguous"):
        th.hamming_refine_topk(qcmp, rows, top.T.contiguous().T, **kw)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.empty(rows.numel() + 1, dtype=torch.int32, device=dev)[1:].view_as(rows)
        th.hamming_refine_topk(qcmp, odd.copy_(rows), top, **kw)
    with pytest.raises(ValueError, match="one device"):
        th.hamming_refine_topk(qcmp.cpu(), rows, top, **kw)


def test_lshrs_past_2_22_slots_takes_the_kernel(dev, rng, monkeypatch):
    """``LSHRS`` at 4,300,000 vectors (2^23 slots, two 2^22-slot blocks):
    each batch takes the kernel once a block and its ids and distances
    equal the same store's plain tail; filtered queries take the plain
    tail. The plain tails are the group selections the kernel's launches
    do not follow."""
    from lshrs_tpu_torch import LSHRS
    from lshrs_tpu_torch.storage.filter import IdFilter

    n, q, dim = 4_300_000, 2_000, 16
    lsh = LSHRS(dim=dim, num_perm=256, num_bands=16, rows_per_band=16, engine="hamming",
                device=dev)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    lsh.index(np.arange(n), x)
    store = lsh._storage
    assert store._capacity == 1 << 23
    qx = x[rng.integers(0, n, q)] + 0.3 * rng.standard_normal((q, dim), dtype=np.float32)
    qw = lsh._hasher.hash_batch_words(qx)

    tails, select = [], th.select_top_groups
    monkeypatch.setattr(th, "select_top_groups",
                        lambda *a, **kw: tails.append(a[1]) or select(*a, **kw))

    def counts():
        kernel = th.hamming_refine_topk.launches - before
        return kernel, len(tails) - kernel

    before = th.hamming_refine_topk.launches
    got = store.query_hamming(qw, 10)
    assert counts() == (2, 0)
    with monkeypatch.context() as mp:
        mp.setattr(th, "refine_kernel_fits", lambda **kw: False)
        want = store.query_hamming(qw, 10)
    assert counts() == (2, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][:, 0] >= 0).all()

    store.query_hamming(qw[:64], 10, where=IdFilter(allowed_ids=np.arange(0, n, 3)))
    assert counts() == (2, 4)
    lsh.close()
