"""Cross-polytope hashing: the port against the JAX package, bit for bit.

Symbols are signed-argmax indices of per-band FWHT rotations; the FWHT is
bit-identical everywhere and the tie rules (first maximum; stable ranking
of equal magnitudes) match, so signature bits and probe bits must be
``array_equal`` across the reference's host and device paths and the
port's host (native C) and PyTorch paths — planted magnitude ties included.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash import crosspolytope as jc
from lshrs_tpu.utils import cp as jcp
from lshrs_tpu_torch.hash import crosspolytope as tc
from lshrs_tpu_torch.utils import cp as tcp

# (dim, num_bands, rows_per_band)
GEOMS = [(24, 4, 5), (16, 3, 2), (64, 8, 6), (100, 2, 8), (768, 4, 8)]


def _x(seed, n, dim, integer=False):
    r = np.random.default_rng(seed)
    if integer:  # exact magnitude ties after the rotations
        return r.integers(-2, 3, (n, dim)).astype(np.float32)
    return r.standard_normal((n, dim)).astype(np.float32)


@pytest.mark.parametrize("r", [2, 3, 8, 11])
def test_geometry_helpers_match(r):
    assert tc.cp_dims_for(r) == jc.cp_dims_for(r) == 1 << (r - 1)
    assert tc.max_cp_probes(r) == jc.max_cp_probes(r)


@pytest.mark.parametrize("dim,r", [(768, 12), (16, 6), (8, 1), (9000, 4)])
def test_invalid_geometry_raises_like_the_reference(dim, r):
    with pytest.raises(ValueError) as want:
        jc.validate_cp_geometry(dim, r)
    with pytest.raises(ValueError) as got:
        tc.validate_cp_geometry(dim, r)
    assert str(got.value) == str(want.value)


def test_valid_geometry_passes():
    tc.validate_cp_geometry(768, 11)
    tc.validate_cp_geometry(768, 8)


@pytest.mark.parametrize("dim,nb,r", GEOMS)
def test_diagonals_match(dim, nb, r):
    a, b = tc.cp_diags(9, dim=dim, num_bands=nb), jc.cp_diags(9, dim=dim, num_bands=nb)
    assert a.shape == (nb, 3, tc.next_pow2(dim)) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("integer", [False, True], ids=["gaussian", "ties"])
@pytest.mark.parametrize("dim,nb,r", GEOMS)
def test_bits_match(dim, nb, r, integer):
    x = _x(dim + r, 37, dim, integer)
    diags = tc.cp_diags(4, dim=dim, num_bands=nb)
    want = np.asarray(jc.cp_bits_jax(jnp.asarray(x), jnp.asarray(diags), num_bands=nb, rows_per_band=r))
    assert want.shape == (37, nb * r) and want.dtype == bool
    np.testing.assert_array_equal(jc.cp_bits_np(x, diags, num_bands=nb, rows_per_band=r), want)
    np.testing.assert_array_equal(tc.cp_bits_np(x, diags, num_bands=nb, rows_per_band=r), want)
    got = tc.cp_bits_torch(
        torch.from_numpy(x), torch.from_numpy(diags), num_bands=nb, rows_per_band=r
    )
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("integer", [False, True], ids=["gaussian", "ties"])
@pytest.mark.parametrize("n_probes", [1, 2, 4])
@pytest.mark.parametrize("dim,nb,r", [g for g in GEOMS if g[2] >= 3])
def test_probe_bits_match(dim, nb, r, n_probes, integer):
    x = _x(dim + n_probes, 21, dim, integer)
    diags = tc.cp_diags(6, dim=dim, num_bands=nb)
    kw = dict(num_bands=nb, rows_per_band=r, n_probes=n_probes)
    # The host path's stable argsort is the tie rule of record.
    want = jc.cp_probe_bits_np(x, diags, **kw)
    assert want.shape == (21, n_probes, nb * r)
    np.testing.assert_array_equal(tc.cp_probe_bits_np(x, diags, **kw), want)
    got = tc.cp_probe_bits_torch(torch.from_numpy(x), torch.from_numpy(diags), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jc.cp_probe_bits_jax(jnp.asarray(x), jnp.asarray(diags), **kw)), want
    )
    # Probe 0 is the plain signature.
    np.testing.assert_array_equal(
        got[:, 0], tc.cp_bits_np(x, diags, num_bands=nb, rows_per_band=r)
    )


def test_probe_symbols_are_distinct_within_a_band():
    dim, nb, r = 24, 4, 5
    x = _x(1, 50, dim, integer=True)
    diags = torch.from_numpy(tc.cp_diags(2, dim=dim, num_bands=nb))
    bits = tc.cp_probe_bits_torch(
        torch.from_numpy(x), diags, num_bands=nb, rows_per_band=r, n_probes=8
    ).numpy()
    sym = (bits.reshape(50, 8, nb, r) * (1 << np.arange(r))).sum(-1)  # (n, T, B)
    for b in range(nb):
        assert all(len(set(row)) == 8 for row in sym[:, :, b])


def test_probe_depth_is_validated():
    x, diags = _x(0, 3, 24), tc.cp_diags(2, dim=24, num_bands=2)
    for n in (0, 17):
        with pytest.raises(ValueError, match="n_probes must be in"):
            tc.cp_probe_bits_np(x, diags, num_bands=2, rows_per_band=5, n_probes=n)
        with pytest.raises(ValueError, match="n_probes must be in"):
            tc.cp_probe_bits_torch(
                torch.from_numpy(x), torch.from_numpy(diags),
                num_bands=2, rows_per_band=5, n_probes=n,
            )


def test_row_slices_do_not_change_the_bits(monkeypatch):
    """The device twins hash in row slices; a slice boundary changes nothing."""
    dim, nb, r = 24, 4, 5
    x, diags = torch.from_numpy(_x(8, 45, dim)), torch.from_numpy(tc.cp_diags(2, dim=dim, num_bands=nb))
    whole = tc.cp_bits_torch(x, diags, num_bands=nb, rows_per_band=r)
    whole_p = tc.cp_probe_bits_torch(x, diags, num_bands=nb, rows_per_band=r, n_probes=3)
    monkeypatch.setattr(tc, "slice_rows", lambda dpad: 16)
    assert torch.equal(tc.cp_bits_torch(x, diags, num_bands=nb, rows_per_band=r), whole)
    assert torch.equal(
        tc.cp_probe_bits_torch(x, diags, num_bands=nb, rows_per_band=r, n_probes=3), whole_p
    )


@pytest.mark.parametrize("num_perm,threshold,dim", [
    (64, 0.5, 128), (128, 0.7, 768), (256, 0.85, 768), (48, 0.6, 32), (256, 0.5, 1024),
])
def test_cp_tuner_matches(num_perm, threshold, dim):
    assert tcp.get_optimal_cp_config(num_perm, threshold, dim) == \
        jcp.get_optimal_cp_config(num_perm, threshold, dim)


@pytest.mark.parametrize("cp_dims", [2, 16, 128])
def test_cp_collision_curve_matches(cp_dims):
    for a, b in zip(tcp.cp_band_collision_curve(cp_dims), jcp.cp_band_collision_curve(cp_dims)):
        np.testing.assert_array_equal(a, b)
    for s in (0.0, 0.35, 0.8, 1.0):
        assert tcp.cp_collision_probability(s, cp_dims, 4) == \
            jcp.cp_collision_probability(s, cp_dims, 4)
    r = cp_dims.bit_length()  # cp_dims = 2^(r-1)
    assert tcp.compute_cp_false_rates(8, r, 0.6) == jcp.compute_cp_false_rates(8, r, 0.6)
    assert tcp.find_optimal_cp_br(8 * r, 0.6, 768) == jcp.find_optimal_cp_br(8 * r, 0.6, 768)
