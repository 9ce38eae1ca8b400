"""LSHHasher across the hash families: the port against the JAX package.

Structured and cross-polytope words, dense wires and probe words are
bit-identical on the host and on the device in both packages (the FWHT's
order is fixed), so those are held ``array_equal`` across packages on both
paths. The gaussian and learned families round a host sgemm and a device
matmul differently, so across packages only their host paths (the same
NumPy sgemm) are compared, and the port's device path is held to its own
host path on margin-safe inputs.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher as JaxHasher
from lshrs_tpu.hash.itq import fit_itq_projection as jax_fit, itq_fit_info as jax_info
from lshrs_tpu_torch.hash.hasher import LSHHasher as TorchHasher
from lshrs_tpu_torch.hash.hasher import hash_coords, hash_words, probe_words_from_coords
from lshrs_tpu_torch.hash.itq import fit_itq_projection, itq_fit_info
from lshrs_tpu_torch.ops.bitpack import words_to_numpy

REPO = Path(__file__).resolve().parents[1]

# (family, num_bands, rows_per_band, dim)
FWHT_CASES = [
    ("structured", 4, 8, 24),
    ("structured", 3, 16, 16),     # num_perm > dpad: several rotation blocks
    ("structured", 2, 40, 48),     # two words per band
    ("structured", 16, 16, 768),
    ("crosspolytope", 4, 5, 24),
    ("crosspolytope", 8, 6, 100),
    ("crosspolytope", 4, 8, 768),
]
ALL_CASES = FWHT_CASES + [("gaussian", 4, 8, 24), ("learned", 6, 6, 40)]


def _pair(family, nb, r, dim, seed=11, **kw):
    return (
        JaxHasher(nb, r, dim, seed=seed, hash_family=family, **kw),
        TorchHasher(nb, r, dim, seed=seed, hash_family=family, device="cpu", **kw),
    )


def _x(seed, n, dim, integer=False):
    g = np.random.default_rng(seed)
    if integer:
        return g.integers(-2, 3, (n, dim)).astype(np.float32) + np.float32(0.0)
    return g.standard_normal((n, dim)).astype(np.float32)


def _margin_safe(h, x, eps=1e-4):
    """Rows whose projections all lie farther than ``eps`` from zero."""
    return x[(np.abs(x @ h.projection_matrix.T) > eps).all(axis=1)]


@pytest.mark.parametrize("family,nb,r,dim", ALL_CASES)
def test_operands_match(family, nb, r, dim):
    jh, th = _pair(family, nb, r, dim)
    assert th.hash_family == family and th.words_per_band == jh.words_per_band
    assert th.max_probes == jh.max_probes
    if family in ("structured", "crosspolytope"):
        np.testing.assert_array_equal(th.diagonals, jh.diagonals)
        np.testing.assert_array_equal(th.device_projection().numpy(), jh.diagonals)
        with pytest.raises(ValueError, match="no projection matrices"):
            th.projections
        with pytest.raises(ValueError, match="assignable only"):
            th.projections = []
    else:
        np.testing.assert_array_equal(th.projection_matrix, jh.projection_matrix)
        np.testing.assert_array_equal(th.device_projection().numpy(), jh.projection_matrix.T)
        with pytest.raises(ValueError, match="no diagonals"):
            th.diagonals
        with pytest.raises(ValueError, match="assignable only"):
            th.diagonals = np.ones((1, 3, 4), np.float32)


@pytest.mark.parametrize("integer", [False, True], ids=["gaussian_x", "ties"])
@pytest.mark.parametrize("family,nb,r,dim", FWHT_CASES)
def test_fwht_family_words_match_on_every_path(family, nb, r, dim, integer):
    jh, th = _pair(family, nb, r, dim)
    x = _x(nb * r + dim, 29, dim, integer)
    want = jh.hash_batch_words_host(x)
    np.testing.assert_array_equal(np.asarray(jh.hash_batch_words(x)), want)
    np.testing.assert_array_equal(th.hash_batch_words_host(x), want)
    np.testing.assert_array_equal(words_to_numpy(th.hash_batch_words(x)), want)
    # a tensor already on the device hashes the same
    np.testing.assert_array_equal(words_to_numpy(th.hash_batch_words(torch.from_numpy(x))), want)
    np.testing.assert_array_equal(th.hash_batch_dense_host(x), jh.hash_batch_dense_host(x))
    # the single-vector and list APIs
    assert th.hash_vector(x[3]).as_tuple() == jh.hash_vector(x[3]).as_tuple()
    assert [s.as_tuple() for s in th.hash_batch(x[:5])] == [s.as_tuple() for s in jh.hash_batch(x[:5])]
    sig = th.hash_vector(x[3])
    np.testing.assert_array_equal(th.signature_to_words(sig), want[3])
    assert th.words_to_signature(want[3]).as_tuple() == sig.as_tuple()


@pytest.mark.parametrize("integer", [False, True], ids=["gaussian_x", "ties"])
@pytest.mark.parametrize("n_probes", [1, 2, 4])
@pytest.mark.parametrize("family,nb,r,dim", FWHT_CASES)
def test_fwht_family_probe_words_match_on_every_path(family, nb, r, dim, n_probes, integer):
    jh, th = _pair(family, nb, r, dim)
    x = _x(n_probes + dim, 17, dim, integer)
    want = th.hash_batch_probe_words_host(x, n_probes)
    assert want.shape == (17, n_probes, nb * th.words_per_band) and want.dtype == np.uint32
    if not (integer and family == "structured"):
        # The reference's sign-family probe ranking leaves the order of
        # exactly equal margins to an unstable sort; the port pins it
        # (stable, ascending bit index) and is held to itself there.
        np.testing.assert_array_equal(jh.hash_batch_probe_words_host(x, n_probes), want)
        np.testing.assert_array_equal(np.asarray(jh.hash_batch_probe_words(x, n_probes)), want)
        np.testing.assert_array_equal(
            th.hash_batch_probe_dense_host(x, n_probes), jh.hash_batch_probe_dense_host(x, n_probes)
        )
    np.testing.assert_array_equal(words_to_numpy(th.hash_batch_probe_words(x, n_probes)), want)
    np.testing.assert_array_equal(want[:, 0], th.hash_batch_words_host(x))
    dense = th.hash_batch_probe_dense_host(x, n_probes)
    assert dense.dtype == np.uint8 and dense.shape[:2] == (17, n_probes)
    np.testing.assert_array_equal(dense[:, 0], th.hash_batch_dense_host(x))


@pytest.mark.parametrize("family,nb,r,dim", [c for c in ALL_CASES if c[0] != "crosspolytope"])
def test_sign_family_probes_flip_distinct_bits(family, nb, r, dim):
    _, th = _pair(family, nb, r, dim)
    x = _x(5, 9, dim)
    t = min(4, r)
    bits = th._probe_bits_host(x, t).reshape(9, t, nb, r)
    for p in range(1, t):
        flipped = bits[:, p] ^ bits[:, 0]
        assert (flipped.sum(-1) == 1).all()  # one bit per band
    # distinct probes flip distinct bits
    flips = np.stack([(bits[:, p] ^ bits[:, 0]).argmax(-1) for p in range(1, t)], axis=1)
    assert all(len(set(col)) == t - 1 for row in flips for col in row.T)


@pytest.mark.parametrize("family", ["gaussian", "learned"])
def test_matmul_families_match_on_the_host(family):
    nb, r, dim = 6, 6, 40
    jh, th = _pair(family, nb, r, dim)
    x = _x(1, 64, dim)
    np.testing.assert_array_equal(th.hash_batch_words_host(x), jh.hash_batch_words_host(x))
    np.testing.assert_array_equal(th.hash_batch_dense_host(x), jh.hash_batch_dense_host(x))
    np.testing.assert_array_equal(th.hash_batch_coords_host(x), jh.hash_batch_coords_host(x))
    np.testing.assert_array_equal(
        th.hash_batch_probe_words_host(x, 3), jh.hash_batch_probe_words_host(x, 3)
    )
    np.testing.assert_array_equal(
        th.hash_batch_probe_dense_host(x, 3), jh.hash_batch_probe_dense_host(x, 3)
    )
    assert th.hash_vector(x[0]).as_tuple() == jh.hash_vector(x[0]).as_tuple()
    safe = _margin_safe(th, x)
    assert len(safe) > 20
    np.testing.assert_array_equal(
        words_to_numpy(th.hash_batch_words(safe)), jh.hash_batch_words_host(safe)
    )
    np.testing.assert_array_equal(
        words_to_numpy(th.hash_batch_probe_words(safe, 1))[:, 0], jh.hash_batch_words_host(safe)
    )


def test_learned_family_with_an_explicit_projection():
    nb, r, dim = 4, 8, 24
    proj = np.random.default_rng(8).standard_normal((nb * r, dim)).astype(np.float32)
    jh, th = _pair("learned", nb, r, dim, projection=proj)
    np.testing.assert_array_equal(th.projection_matrix, proj)
    assert th.projection_matrix is not proj
    x = _margin_safe(th, _x(2, 80, dim))
    want = jh.hash_batch_words_host(x)
    np.testing.assert_array_equal(th.hash_batch_words_host(x), want)
    np.testing.assert_array_equal(words_to_numpy(th.hash_batch_words(x)), want)
    np.testing.assert_array_equal(np.asarray(jh.hash_batch_words(x)), want)
    with pytest.raises(ValueError, match="projection must have shape"):
        TorchHasher(nb, r, dim, hash_family="learned", projection=proj[:, :5], device="cpu")
    with pytest.raises(ValueError, match="requires hash_family='learned'"):
        TorchHasher(nb, r, dim, projection=proj, device="cpu")
    # assigning projections re-uploads the device operand
    th.device_projection()
    th.projections = [2 * m for m in th.projections]
    np.testing.assert_array_equal(th.device_projection().numpy(), 2 * proj.T)


def test_diagonals_are_assignable_and_validated():
    _, th = _pair("structured", 4, 8, 24)
    other = TorchHasher(4, 8, 24, seed=99, hash_family="structured", device="cpu")
    x = _x(0, 10, 24)
    assert not np.array_equal(th.hash_batch_words_host(x), other.hash_batch_words_host(x))
    th.device_projection()
    th.diagonals = other.diagonals
    np.testing.assert_array_equal(th.hash_batch_words_host(x), other.hash_batch_words_host(x))
    np.testing.assert_array_equal(
        words_to_numpy(th.hash_batch_words(x)), other.hash_batch_words_host(x)
    )
    with pytest.raises(ValueError, match=r"\+-1 of shape"):
        th.diagonals = np.zeros_like(other.diagonals)
    with pytest.raises(ValueError, match=r"\+-1 of shape"):
        th.diagonals = other.diagonals[:, :2]


@pytest.mark.parametrize("kw,match", [
    (dict(num_bands=0, rows_per_band=4, dim=8), "num_bands"),
    (dict(num_bands=2, rows_per_band=0, dim=8), "rows_per_band"),
    (dict(num_bands=2, rows_per_band=4, dim=0), "dim"),
    (dict(num_bands=2, rows_per_band=4, dim=8, hash_family="minhash"), "hash_family"),
    (dict(num_bands=2, rows_per_band=12, dim=8, hash_family="crosspolytope"), "cp_dims"),
    (dict(num_bands=2, rows_per_band=1, dim=8, hash_family="crosspolytope"), "rows_per_band >= 2"),
])
def test_constructor_validation_matches(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        TorchHasher(device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        JaxHasher(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family,r,bound", [("structured", 8, "rows_per_band"),
                                            ("crosspolytope", 5, "cp_dims")])
def test_probe_depth_is_validated(family, r, bound):
    jh, th = _pair(family, 4, r, 24)
    x = _x(0, 2, 24)
    for n in (0, jh.max_probes + 1):
        with pytest.raises(ValueError, match=bound) as want:
            jh.hash_batch_probe_words_host(x, n)
        for call in (th.hash_batch_probe_words_host, th.hash_batch_probe_words,
                     th.hash_batch_probe_dense_host):
            with pytest.raises(ValueError, match=bound) as got:
                call(x, n)
            assert str(got.value) == str(want.value)


def test_bad_shapes_raise():
    _, th = _pair("structured", 4, 8, 24)
    for call in (th.hash_batch_words, th.hash_batch_words_host, th.hash_batch_dense_host,
                 th.hash_batch_coords_host, th.hash_batch):
        with pytest.raises(ValueError):
            call(np.zeros((3, 5), np.float32))
    with pytest.raises(ValueError, match="dimension 24"):
        th.hash_vector(np.zeros(5, np.float32))
    _, tc = _pair("crosspolytope", 4, 5, 24)
    with pytest.raises(ValueError, match="no per-bit projection"):
        tc.hash_batch_coords_host(np.ones((2, 24), np.float32))
    with pytest.raises(ValueError, match="no per-bit projection"):
        hash_coords(torch.ones(2, 24), tc.device_projection(), num_perm=20,
                    hash_family="crosspolytope")


def test_structured_hash_slices_rows(monkeypatch):
    import lshrs_tpu_torch.hash.hasher as mod

    _, th = _pair("structured", 3, 16, 16)
    x = torch.from_numpy(_x(4, 50, 16))
    kw = dict(num_bands=3, rows_per_band=16, hash_family="structured")
    whole = hash_words(x, th.device_projection(), **kw)
    monkeypatch.setattr(mod, "slice_rows", lambda dpad: 7)
    assert torch.equal(hash_words(x, th.device_projection(), **kw), whole)


def test_probe_words_from_coords_planted_ties():
    """Equal margins flip in ascending bit order, as a stable ranking does."""
    coords = torch.tensor([[0.5, -0.5, 0.5, 2.0, -1.0, 1.0, -3.0, 1.0]])
    got = words_to_numpy(
        probe_words_from_coords(coords, num_bands=2, rows_per_band=4, n_probes=4)
    )[0]
    base = [0b1101, 0b1010]  # bits of coords > 0, little-endian per band
    flips = [[0, 1, 2], [0, 1, 3]]  # ascending |coord|, index order on ties
    assert got[0].tolist() == base
    for t in range(1, 4):
        assert got[t].tolist() == [base[b] ^ (1 << flips[b][t - 1]) for b in range(2)]


@pytest.mark.parametrize("dim,num_perm,n", [(24, 16, 400), (16, 16, 300), (12, 20, 200)])
def test_itq_fit_matches(dim, num_perm, n):
    """Host LAPACK on both sides: close, and identical words wherever no
    projection lies within 1e-4 of zero."""
    g = np.random.default_rng(dim)
    sample = (g.standard_normal((n, dim)) + 2.0 * g.standard_normal(dim)).astype(np.float32)
    want, got = jax_fit(sample, num_perm, seed=3), fit_itq_projection(sample, num_perm, seed=3)
    assert got.shape == (num_perm, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    wi, gi = jax_info(sample, want), itq_fit_info(sample, got)
    assert gi.keys() == wi.keys()
    for k in gi:
        np.testing.assert_allclose(gi[k], wi[k], rtol=1e-4, atol=1e-5)
    r = 4
    jh, th = _pair("learned", num_perm // r, r, dim, projection=want)
    th2 = TorchHasher(num_perm // r, r, dim, hash_family="learned", projection=got, device="cpu")
    x = _x(1, 200, dim)
    safe = x[(np.abs(x @ want.T) > 1e-4).all(axis=1)]
    assert len(safe) > 100
    np.testing.assert_array_equal(th2.hash_batch_words_host(safe), jh.hash_batch_words_host(safe))
    np.testing.assert_array_equal(th.hash_batch_words_host(safe), jh.hash_batch_words_host(safe))


def test_itq_validation():
    with pytest.raises(ValueError, match="2D"):
        fit_itq_projection(np.zeros(5, np.float32), 4)
    with pytest.raises(ValueError):
        fit_itq_projection(np.zeros((1, 5), np.float32), 4)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import lshrs_tpu_torch.hash.fwht, lshrs_tpu_torch.hash.crosspolytope\n"
        "import lshrs_tpu_torch.hash.itq, lshrs_tpu_torch.utils.cp\n"
        "import lshrs_tpu_torch.native.build, lshrs_tpu_torch.storage.filter\n"
        "from lshrs_tpu_torch import LSHRS, IdFilter\n"
        "import numpy as np\n"
        "l = LSHRS(dim=24, num_perm=20, num_bands=4, rows_per_band=5,\n"
        "          hash_family='crosspolytope', multiprobe=2, hash_mode='host', device='cpu')\n"
        "x = np.random.default_rng(0).standard_normal((30, 24)).astype(np.float32)\n"
        "l.index(list(range(30)), x)\n"
        "assert l.query(x[4], top_k=1, where=IdFilter(disallowed_ids=[5])) == [4]\n"
        "from lshrs_tpu_torch.native import native_status\n"
        "assert native_status().startswith('loaded'), native_status()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lshrs_tpu.'))\n"
        "       or m == 'lshrs_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=180)
