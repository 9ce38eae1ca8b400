"""The group selection: ``ops/scan.py::select_top_groups`` and kernel
``group_select`` (``csrc/group_select.cu``).

On the CPU the selection is ``torch.topk`` (the kernel's plain version);
these cases count everywhere: the route test ``select_kernel_fits``, the
one choice between the kernel's wrapper and ``torch.topk`` in
``select_top_groups``, and the wrapper's checks of dtype, shape and
contiguity. The cases marked ``cuda`` need an NVIDIA GPU and skip
elsewhere (the check is made in a fixture); the file imports torch, NumPy
and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_group_select.py

There the kernel's keys are held to ``torch.topk``'s bit for bit, and its
indices to a stable sort's (key desc, index asc), at the benchmark cells'
widths, odd and tiny widths, small and large batches, dead rows, ties and
the int32 extremes; and a blocked store takes the kernel once a block.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lshrs_tpu_torch.storage.device as device_mod
from lshrs_tpu_torch import DeviceStore
from lshrs_tpu_torch.ops import scan

INT_MIN, INT_MAX = -(2**31), 2**31 - 1
LIMIT = 256  # the kernel's largest m


@pytest.fixture
def dev() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (group_select has no CPU build)")
    return torch.device("cuda")


def _keys(kind: str, q: int, ng: int, m: int, seed: int = 0) -> torch.Tensor:
    """``(q, ng)`` int32 group maxima of one of these kinds:

    - ``hamming``: B2's keys, ``scaled * 2^21 + tie`` with distinct ties;
    - ``random``: uniform over int32;
    - ``dead``: every group dead (one negative key everywhere);
    - ``few_alive``: ``m // 2`` alive groups a row, the rest dead;
    - ``neg_ties``: a handful of negative values, heavily tied;
    - ``extremes``: a third ``INT32_MIN``, a third ``INT32_MAX``;
    - ``ascending``: keys rising along the row (each tile beats the last).

    Past 64 rows the first 64 repeat (each row is selected on its own).
    """
    rows = min(q, 64)
    rng = np.random.default_rng(seed)
    q, full = rows, q
    if kind == "hamming":
        scaled = rng.binomial(256, 0.5, (q, ng)) + 1
        tie = np.stack([rng.permutation(1 << 21)[:ng] for _ in range(q)])
        keys = scaled.astype(np.int64) * (1 << 21) + tie
    elif kind == "random":
        keys = rng.integers(INT_MIN, INT_MAX, (q, ng), endpoint=True)
    elif kind == "dead":
        keys = np.full((q, ng), -(1 << 21))
    elif kind == "few_alive":
        keys = np.full((q, ng), -(1 << 21))
        alive = np.argsort(rng.random((q, ng)), axis=1)[:, : max(1, m // 2)]
        np.put_along_axis(keys, alive, rng.integers(1 << 21, 1 << 30, alive.shape), axis=1)
    elif kind == "neg_ties":
        keys = rng.choice(np.array([-7, -(1 << 20), -(1 << 29), INT_MIN + 1]), (q, ng))
    elif kind == "extremes":
        keys = rng.choice(np.array([INT_MIN, INT_MAX, 0, -1]), (q, ng), p=[0.33, 0.33, 0.17, 0.17])
    elif kind == "ascending":
        keys = np.broadcast_to(np.arange(ng) * 8 + INT_MIN, (q, ng)) + rng.integers(0, 8, (q, ng))
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.tile(keys.astype(np.int32), (-(-full // rows), 1))[:full])


# ---------------------------------------------------------------------------
# Everywhere: the plain version, the route test, the checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,ng,m,kind", [
    (3, 18_493, 10, "hamming"),
    (2, 65_536, 10, "hamming"),
    (4, 2_048, 128, "random"),
    (5, 100, 100, "random"),
    (2, 3, 3, "extremes"),
    (3, 500, 32, "neg_ties"),
    (2, 300, 10, "dead"),
    (1, 34_464, 10, "hamming"),
    (4, 18_493, 1, "few_alive"),
    (3, 5_000, LIMIT, "ascending"),
    (6, 7, 7, "neg_ties"),
])
def test_select_top_groups_on_the_cpu_is_topk(q, ng, m, kind):
    gmax = _keys(kind, q, ng, m)
    before = scan.select_top_groups.launches
    got = scan.select_top_groups(gmax, m)
    assert torch.equal(got, torch.topk(gmax, m, dim=1).indices)
    assert torch.equal(scan.group_select(gmax, m), got)
    assert scan.select_top_groups.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("m,ng,fits", [
    (1, 1, True),
    (10, 18_493, True),
    (128, 65_536, True),
    (LIMIT, 65_536, True),
    (LIMIT, LIMIT, True),
    (LIMIT + 1, 65_536, False),
    (LIMIT, LIMIT - 1, False),
    (11, 10, False),
    (0, 10, False),
    (-1, 10, False),
])
def test_select_kernel_fits_at_and_past_its_limits(m, ng, fits):
    assert scan.select_kernel_fits(m, ng) is fits


def test_past_the_limit_the_selection_stays_topk():
    gmax = _keys("random", 2, 4_096, LIMIT + 1)
    assert torch.equal(scan.select_top_groups(gmax, LIMIT + 1),
                       torch.topk(gmax, LIMIT + 1, dim=1).indices)
    with pytest.raises(ValueError, match="m <="):
        scan.group_select(gmax, LIMIT + 1)


@pytest.mark.parametrize("m,ng,kernel", [
    (1, 1, True),
    (10, 18_493, True),
    (LIMIT, 4_096, True),
    (LIMIT + 1, 4_096, False),
    (300, 65_536, False),
])
def test_select_top_groups_takes_the_wrapper_within_its_limits(m, ng, kernel, monkeypatch):
    """One choice, on either device: ``group_select`` (which picks the
    kernel or its plain version by device) within ``select_kernel_fits``,
    ``torch.topk`` past it."""
    calls = []
    real = scan.group_select
    monkeypatch.setattr(scan, "group_select", lambda g, k: calls.append(k) or real(g, k))
    gmax = _keys("random", 2, ng, m)
    got = scan.select_top_groups(gmax, m)
    assert calls == ([m] if kernel else [])
    assert torch.equal(got, torch.topk(gmax, m, dim=1).indices)


def test_no_queries_select_nothing_and_count_no_launch():
    gmax = torch.zeros((0, 64), dtype=torch.int32)
    before = scan.select_top_groups.launches
    assert scan.group_select(gmax, 10).shape == (0, 10)
    assert scan.select_top_groups(gmax, 10).shape == (0, 10)
    assert scan.select_top_groups.launches == before


@pytest.mark.parametrize("bad,err,match", [
    (lambda g: g.to(torch.int64), TypeError, "int32"),
    (lambda g: g.to(torch.float32), TypeError, "int32"),
    (lambda g: g[0], ValueError, "shape"),
    (lambda g: g[None], ValueError, "shape"),
    (lambda g: g.t().contiguous().t(), ValueError, "contiguous"),
    (lambda g: g[:, ::2], ValueError, "contiguous"),
])
def test_group_select_checks_dtype_shape_and_contiguity(bad, err, match):
    gmax = _keys("random", 6, 64, 10)
    with pytest.raises(err, match=match):
        scan.group_select(bad(gmax), 10)


@pytest.mark.parametrize("m", [0, LIMIT + 1, 65])
def test_group_select_checks_m(m):
    with pytest.raises(ValueError, match="m <="):
        scan.group_select(_keys("random", 2, 64, 1), m)


# ---------------------------------------------------------------------------
# On the card: the kernel
# ---------------------------------------------------------------------------


def _same(gmax: torch.Tensor, m: int) -> torch.Tensor:
    """The kernel through ``select_top_groups``: one launch; its keys ==
    ``torch.topk``'s; its indices distinct, in range, and those of a
    stable sort by key descending (equal keys by ascending index)."""
    before = scan.select_top_groups.launches
    got = scan.select_top_groups(gmax, m)
    torch.cuda.synchronize()
    assert scan.select_top_groups.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (gmax.shape[0], m)
    ng = gmax.shape[1]
    assert bool(((got >= 0) & (got < ng)).all())
    assert torch.equal(gmax.gather(1, got), torch.topk(gmax, m, dim=1).values)
    order = torch.sort(gmax, dim=1, descending=True, stable=True).indices[:, :m]
    assert torch.equal(got, order)
    srt = got.sort(dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("q,ng,m,kind", [
    (10_000, 18_493, 10, "hamming"),   # glove100.batch's selection
    (10_000, 65_536, 10, "hamming"),   # wiki6m4.batch's first block
    (10_000, 34_464, 10, "hamming"),   # ... and its second
    (2_048, 65_536, 128, "hamming"),   # the cascade's 128-group pool
    (10_000, 18_493, 1, "random"),
    (3_000, 18_493, 32, "random"),
    (1_000, 3 * 4096 + 5, LIMIT, "random"),  # the limit, a ragged last tile
    (1, 18_493, 10, "hamming"),        # Q = 1: one block
    (3, 18_493, 10, "random"),
    (1, 65_536, LIMIT, "random"),
    (3, 3, 3, "random"),               # widths below 4: head and tail only
    (7, 2, 1, "random"),
    (5, 1, 1, "random"),
    (200, 18_493, 10, "dead"),         # every group dead
    (300, 18_493, 32, "few_alive"),    # fewer alive groups than m
    (500, 18_493, 128, "neg_ties"),    # heavy negative ties
    (2, 65_536, 10, "neg_ties"),       # ... over a whole wide row
    (300, 18_493, 10, "extremes"),     # INT32_MIN and INT32_MAX
    (100, 65_536, 10, "ascending"),    # the floor rises every tile
])
def test_kernel_matches_topk(q, ng, m, kind, dev):
    _same(_keys(kind, q, ng, m, seed=q + ng + m).to(dev), m)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_reads_rows_at_any_4_byte_offset(offset, dev):
    """A contiguous view that starts past a 16-byte boundary: every row's
    head and tail are peeled."""
    flat = _keys("random", 1, 64 * 1_001 + offset, 1, seed=offset).reshape(-1).to(dev)
    _same(flat[offset:].view(64, 1_001), 10)


@pytest.mark.cuda
def test_kernel_takes_no_queries_and_refuses_another_device(dev):
    gmax = _keys("random", 4, 100, 10).to(dev)
    before = scan.select_top_groups.launches
    assert scan.group_select(gmax[:0], 10).shape == (0, 10)  # no launch, none counted
    with pytest.raises(ValueError, match="contiguous"):
        scan.group_select(gmax[:, :50], 10)
    wide = scan.select_top_groups(gmax, 100)  # m = ng = 100 fits
    over = _keys("random", 4, 4_096, LIMIT + 1).to(dev)
    scan.select_top_groups(over, LIMIT + 1)  # past the limit: torch.topk
    assert scan.select_top_groups.launches == before + 1
    assert torch.equal(gmax.gather(1, wide), torch.topk(gmax, 100, dim=1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("n,blocks", [(900, 1), (3 * 1024 + 300, 4)])
def test_a_blocked_store_selects_once_a_block(n, blocks, dev, monkeypatch):
    """A bitplane store in blocks of 1,024 slots (patched down from 2^22):
    one kernel launch a block, as ``glove100.batch`` takes one and
    ``wiki6m4.batch`` two, and the same ids and distances as the same
    store on the CPU."""
    monkeypatch.setattr(device_mod, "hamming_block_slots", lambda p: 1024)
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    ids = rng.permutation(20 * n).astype(np.int64)[:n]
    qw = words[rng.integers(0, n, 64)] ^ (rng.integers(0, 1 << 16, (64, 16), dtype=np.uint32)
                                          & 0x0101)
    out = {}
    for where in ("cpu", "cuda"):
        store = DeviceStore(num_bands=16, rows_per_band=16, chunk_size=512,
                            initial_capacity=1024, enable_hamming=True, device=where)
        store.add_signature_batch(ids, words)
        before = scan.select_top_groups.launches
        out[where] = store.query_hamming(qw, 10)
        assert scan.select_top_groups.launches - before == (blocks if where == "cuda" else 0)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
