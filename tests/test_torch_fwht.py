"""Structured (FWHT) hashing: the port against the JAX package, bit for bit.

The FWHT's pass order is normative, so the rotated float32 coordinates —
not only the hash bits — must be identical across the reference's NumPy
and JAX paths and the port's native C, NumPy and PyTorch paths. Every
comparison here is ``array_equal``.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash import fwht as jf
from lshrs_tpu_torch.hash import fwht as tf
from lshrs_tpu_torch.native import load_fwht_library, native_cache_dir, native_status

REPO = Path(__file__).resolve().parents[1]

# (dim, num_perm): a power-of-two dim, a padded dim, several rotation
# blocks (num_perm > dpad), a partial last block, and the flagship shape.
SHAPES = [(16, 8), (24, 32), (20, 70), (8, 24), (48, 64), (768, 256)]


def _x(seed, n, dim):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 9, 4096, 70000])
def test_next_pow2_matches(n):
    assert tf.next_pow2(n) == jf.next_pow2(n)
    assert tf.MAX_DPAD == jf.MAX_DPAD


@pytest.mark.parametrize("dim,num_perm", SHAPES)
@pytest.mark.parametrize("seed", [0, 7])
def test_diagonals_match(dim, num_perm, seed):
    a = tf.structured_diags(seed, dim=dim, num_perm=num_perm)
    b = jf.structured_diags(seed, dim=dim, num_perm=num_perm)
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) <= {-1.0, 1.0}


def test_diagonals_reject_wide_dims():
    with pytest.raises(ValueError, match="dim <= 8192"):
        tf.structured_diags(0, dim=9000, num_perm=16)


@pytest.mark.parametrize("d", [2, 8, 64, 1024])
def test_fwht_passes_match(d):
    y = _x(d, 5, d)
    want = np.asarray(jf.fwht_jax(jnp.asarray(y)))
    np.testing.assert_array_equal(jf.fwht_np(y), want)
    np.testing.assert_array_equal(tf.fwht_np(y), want)
    np.testing.assert_array_equal(tf.fwht_torch(torch.from_numpy(y)).numpy(), want)


def test_fwht_is_hadamard():
    h = tf.fwht_torch(torch.eye(16)).numpy()
    np.testing.assert_array_equal(h @ h.T, 16 * np.eye(16, dtype=np.float32))
    assert set(np.unique(h)) == {-1.0, 1.0}


def test_native_library_loads_into_the_build_directory():
    lib = load_fwht_library()
    assert lib is not None, native_status()
    assert native_status().startswith("loaded: ")
    so = Path(native_status().split(": ", 1)[1])
    assert so.parent == native_cache_dir() == REPO / "build" / "lshrs_tpu_torch"
    assert so.name.startswith("fwht_host-") and so.exists()


def test_native_source_is_the_reference_source():
    a = (REPO / "lshrs_tpu_torch" / "native" / "fwht.c").read_bytes()
    assert a == (REPO / "lshrs_tpu" / "native" / "fwht.c").read_bytes()


@pytest.mark.parametrize("dim,num_perm", SHAPES)
def test_structured_coords_match_everywhere(dim, num_perm):
    """C == NumPy == PyTorch (port) == NumPy == JAX (reference), exactly."""
    x = _x(dim + num_perm, 33, dim)
    diags = tf.structured_diags(5, dim=dim, num_perm=num_perm)
    want = np.asarray(jf.structured_coords_jax(jnp.asarray(x), diags, num_perm))
    assert want.shape == (33, num_perm)
    np.testing.assert_array_equal(jf.structured_coords_np(x, diags, num_perm), want)
    assert load_fwht_library() is not None
    np.testing.assert_array_equal(tf.structured_coords_np(x, diags, num_perm), want)  # C
    np.testing.assert_array_equal(tf._structured_coords_numpy(x, diags, num_perm), want)
    got = tf.structured_coords_torch(torch.from_numpy(x), torch.from_numpy(diags), num_perm)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_structured_coords_with_integer_inputs_tie_exactly():
    """Integer-valued inputs make many rotated coordinates exactly equal
    (and exactly zero): every path still agrees bit for bit, zeros' signs
    included."""
    x = np.random.default_rng(3).integers(-2, 3, (40, 24)).astype(np.float32)
    diags = tf.structured_diags(1, dim=24, num_perm=32)
    want = np.asarray(jf.structured_coords_jax(jnp.asarray(x), diags, 32))
    assert (want == 0).any() and len(np.unique(np.abs(want))) < want.size // 4
    for got in (
        tf.structured_coords_np(x, diags, 32),
        tf._structured_coords_numpy(x, diags, 32),
        tf.structured_coords_torch(torch.from_numpy(x), torch.from_numpy(diags), 32).numpy(),
    ):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_numpy_path_serves_when_the_library_is_disabled():
    code = (
        "import numpy as np\n"
        "from lshrs_tpu_torch.hash import fwht\n"
        "from lshrs_tpu_torch.native import load_fwht_library, native_status\n"
        "assert load_fwht_library() is None and 'LSHRS_TPU_DISABLE_NATIVE' in native_status()\n"
        "x = np.random.default_rng(0).standard_normal((7, 24)).astype(np.float32)\n"
        "d = fwht.structured_diags(2, dim=24, num_perm=40)\n"
        "a = fwht.structured_coords_np(x, d, 40)\n"
        "assert np.array_equal(a, fwht._structured_coords_numpy(x, d, 40))\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
        env={**__import__("os").environ, "LSHRS_TPU_DISABLE_NATIVE": "1"},
    )


def test_slice_rows_bounds_one_temporary():
    assert tf.slice_rows(1024) == 65536
    assert tf.slice_rows(1024) * 1024 * 4 == tf.SLICE_BYTES
    assert tf.slice_rows(8192) * 8192 * 4 == tf.SLICE_BYTES


def test_native_hashing_is_thread_safe():
    x = _x(0, 64, 96)
    d = tf.structured_diags(1, dim=96, num_perm=64)
    want = tf.structured_coords_np(x, d, 64)
    with ThreadPoolExecutor(8) as ex:
        for got in ex.map(lambda _: tf.structured_coords_np(x, d, 64), range(16)):
            np.testing.assert_array_equal(got, want)
