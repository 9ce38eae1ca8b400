"""Kernels B1/B2: the port's plain versions against the JAX Pallas kernels
(interpret mode) and the jnp formulation, and the wrappers' routing. The
hand-written CUDA kernels are held to these plain versions on a GPU by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The Pallas kernels group slots strided within each chunk (slots
``ci*chunk + j + i*ngc`` form group ``ci*ngc + j``), the port groups them
contiguously. The JAX side gets its slots permuted so that its group ``g``
holds exactly the port's group ``g``; the outputs then compare
element for element.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import asymmetric as jasym
from lshrs_tpu.ops import pallas_scan as jps
from lshrs_tpu.ops.scan import band_counts_t as j_band_counts_t
from lshrs_tpu.ops.scan import compute_global_tie
from lshrs_tpu_torch.ops import _build
from lshrs_tpu_torch.ops import group_max as gm

C, Q, GROUP, CHUNK, Q_TILE = 1024, 16, 64, 256, 8


def _strided_positions(c: int, chunk: int, group: int) -> np.ndarray:
    """Pallas slot position of each contiguous (port) slot."""
    s = np.arange(c)
    g, i = s // group, s % group
    ngc = chunk // group
    return (g // ngc) * chunk + (g % ngc) + i * ngc


def _to_strided(a: np.ndarray, axis: int) -> np.ndarray:
    out = np.empty_like(a)
    idx = [slice(None)] * a.ndim
    idx[axis] = _strided_positions(a.shape[axis], CHUNK, GROUP)
    out[tuple(idx)] = a
    return out


def _store(rng, num_bands, rows, dim=16, n=600):
    """Host-hashed store (600 live rows, 10% of them tombstoned) and
    near-duplicate queries, so counts spread over 0..num_bands."""
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=3)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    sig_t = np.zeros((words.shape[1], C), np.uint32)
    sig_t[:, :n] = words.T
    ids = np.full(C, -1, np.int32)
    ids[:n] = rng.permutation(10_000)[:n]
    ids[:n][rng.random(n) < 0.1] = -1
    tie = np.asarray(compute_global_tie(jnp.asarray(ids)))
    qx = X[rng.integers(0, n, Q)] + 0.3 * rng.standard_normal((Q, dim)).astype(np.float32)
    return h, sig_t, ids, tie, h.hash_batch_words_host(qx)


def _probed(qwords, probes, words_per_band):
    """Probe t > 0 flips bit t-1 of each band's first word (distinct probes)."""
    flips = np.zeros(qwords.shape[1], np.uint32)
    variants = [qwords]
    for t in range(1, probes):
        flips[:] = 0
        flips[::words_per_band] = np.uint32(1 << (t - 1))
        variants.append(qwords ^ flips)
    return np.ascontiguousarray(np.concatenate(variants, axis=1))


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("probes", [1, 2, 3])
@pytest.mark.parametrize("num_bands,rows", [(4, 8), (16, 16), (2, 40), (24, 8), (48, 8), (12, 16)])
def test_group_max_keys_ref_matches_pallas_and_jnp(num_bands, rows, probes, rng):
    h, sig_t, ids, tie, qwords = _store(rng, num_bands, rows)
    qw = _probed(qwords, probes, h.words_per_band)
    scale = gm.key_scale(C)
    kw = dict(num_bands=num_bands, words=h.words_per_band, group=GROUP, scale=scale, probes=probes)

    got = gm.group_max_keys_ref(_t(sig_t), _t(tie), _t(qw), **kw).numpy()

    pallas = np.asarray(
        jps.group_max_keys(
            jnp.asarray(_to_strided(sig_t, 1)), jnp.asarray(_to_strided(tie, 0)),
            jnp.asarray(qw), chunk=CHUNK, q_tile=Q_TILE, interpret=True, **kw,
        )
    )
    np.testing.assert_array_equal(got, pallas)

    # The jnp formulation (dead slots key 0 there, <= 0 in the kernels):
    # equal on every group holding an alive slot.
    counts = np.asarray(j_band_counts_t(jnp.asarray(sig_t), jnp.asarray(qw), num_bands, probes))
    key = counts * (tie >= 0) * scale + np.maximum(tie, 0)
    jnp_gmax = key.reshape(Q, C // GROUP, GROUP).max(-1)
    alive = (tie.reshape(-1, GROUP) >= 0).any(-1)
    np.testing.assert_array_equal(got[:, alive], jnp_gmax[:, alive])
    assert (got[:, ~alive] <= 0).all()
    assert (got >= scale).any(), "no collisions: the check would be vacuous"


@pytest.mark.parametrize("asymmetric", [False, True])
def test_hamming_group_max_keys_ref_matches_pallas(asymmetric, rng):
    from lshrs_tpu.ops.hamming import unpack_bitplanes

    num_bands, rows = 4, 16
    h, sig_t, ids, tie, qwords = _store(rng, num_bands, rows)
    p = num_bands * rows
    planes = np.asarray(
        unpack_bitplanes(jnp.asarray(sig_t.T.copy()), num_bands=num_bands, rows_per_band=rows)
    )
    scale = gm.key_scale(C)
    kw = dict(group=GROUP, scale=scale)
    if asymmetric:
        qbits = rng.integers(-127, 128, (Q, p)).astype(np.int8)
        shift = gm.asymmetric_shift(p, C)
        assert shift == jasym.asymmetric_shift(p, C)
        kw.update(offset=p * jasym.QMAX, shift=shift)
    else:
        qbits = np.asarray(unpack_bitplanes(jnp.asarray(qwords), num_bands=num_bands, rows_per_band=rows))

    got = gm.hamming_group_max_keys_ref(
        _t(planes), _t(tie), _t(qbits), **kw
    ).numpy()
    pallas = np.asarray(
        jps.hamming_group_max_keys(
            jnp.asarray(_to_strided(planes, 0)), jnp.asarray(_to_strided(tie, 0)),
            jnp.asarray(qbits), chunk=CHUNK, q_tile=Q_TILE, interpret=True, **kw,
        )
    )
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("capacity", [1, 2, 1000, 1 << 17, 1 << 20, 1 << 27])
def test_key_helpers_match(capacity):
    assert gm.key_scale(capacity) == jps.key_scale(capacity)
    for nb in (4, 16, 64):
        assert gm.supports_fast_path(nb, capacity) == jps.supports_fast_path(nb, capacity)
    if 2**31 // jps.key_scale(capacity) > 2:
        for qmax in (7, 127):
            assert gm.asymmetric_shift(256, capacity, qmax) == jasym.asymmetric_shift(256, capacity, qmax)


def test_cpu_wrappers_take_the_plain_version(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build or launch a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    h, sig_t, ids, tie, qwords = _store(rng, 4, 8)
    kw = dict(num_bands=4, words=1, group=GROUP, scale=gm.key_scale(C))
    before = (gm.group_max_keys.launches, gm.hamming_group_max_keys.launches)
    got = gm.group_max_keys(_t(sig_t), _t(tie), _t(qwords), **kw)
    assert torch.equal(got, gm.group_max_keys_ref(_t(sig_t), _t(tie), _t(qwords), **kw))
    planes = torch.ones((C, 32), dtype=torch.int8)
    qb = torch.ones((Q, 32), dtype=torch.int8)
    got2 = gm.hamming_group_max_keys(planes, _t(tie), qb, group=GROUP, scale=gm.key_scale(C))
    assert torch.equal(
        got2, gm.hamming_group_max_keys_ref(planes, _t(tie), qb, group=GROUP, scale=gm.key_scale(C))
    )
    assert (gm.group_max_keys.launches, gm.hamming_group_max_keys.launches) == before


def test_wrappers_reject_other_devices_and_bad_inputs():
    sig = torch.zeros((4, 256), dtype=torch.int32, device="meta")
    tie = torch.zeros((256,), dtype=torch.int32, device="meta")
    qw = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    kw = dict(num_bands=4, words=1, group=64, scale=256)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.group_max_keys(sig, tie, qw, **kw)
    sig, tie, qw = (torch.zeros(t.shape, dtype=torch.int32) for t in (sig, tie, qw))
    with pytest.raises(TypeError):
        gm.group_max_keys(sig.float(), tie, qw, **kw)
    with pytest.raises(ValueError, match="group"):
        gm.group_max_keys(sig, tie, qw, **{**kw, "group": 48})
    planes = torch.zeros((256, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gm.hamming_group_max_keys(planes, tie.to("meta"), planes[:3], group=64, scale=256)

