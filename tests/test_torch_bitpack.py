"""Bitpack parity: every function of the port against the JAX package."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.ops import bitpack as jbp
from lshrs_tpu_torch.ops import bitpack as tbp

ROWS = [8, 16, 40]


def _bits(rng, n, num_bands, r):
    bits = rng.random((n, num_bands * r)) < 0.5
    bits[0] = True  # every word's high bits set, bit 31 included
    return bits


def _u32(t: torch.Tensor) -> np.ndarray:
    return tbp.words_to_numpy(t)


@pytest.mark.parametrize("r", [1, 7, 8, 15, 16, 17, 31, 32, 33, 40, 64])
def test_sizes_match(r):
    assert tbp.words_per_band(r) == jbp.words_per_band(r)
    assert tbp.bytes_per_band(r) == jbp.bytes_per_band(r)
    assert tbp.narrow_refine_r(r) == jbp.narrow_refine_r(r)
    if tbp.narrow_refine_r(r):
        for b in (1, 3, 16, 17):
            assert tbp.narrow_words_count(b, r) == jbp.narrow_words_count(b, r)


@pytest.mark.parametrize("r", ROWS)
def test_pack_bits_to_words(r, rng):
    nb = 5
    bits = _bits(rng, 33, nb, r)
    want = np.asarray(jbp.pack_bits_to_words(jnp.asarray(bits), num_bands=nb, rows_per_band=r))
    got = tbp.pack_bits_to_words(torch.from_numpy(bits), num_bands=nb, rows_per_band=r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    if r == 40:  # word 0 of a band holds rows 0..31: bit 31 is set
        assert (want[0, 0] >> 31) == 1


@pytest.mark.parametrize("r", ROWS)
def test_numpy_packers(r, rng):
    nb = 5
    bits = _bits(rng, 33, nb, r)
    kw = dict(num_bands=nb, rows_per_band=r)
    np.testing.assert_array_equal(
        tbp.pack_bits_to_words_np(bits, **kw), jbp.pack_bits_to_words_np(bits, **kw)
    )
    np.testing.assert_array_equal(
        tbp.pack_bits_dense_np(bits, **kw), jbp.pack_bits_dense_np(bits, **kw)
    )


@pytest.mark.parametrize("r", ROWS)
def test_dense_to_words(r, rng):
    nb = 5
    kw = dict(num_bands=nb, rows_per_band=r)
    bits = _bits(rng, 33, nb, r)
    dense = jbp.pack_bits_dense_np(bits, **kw)
    want = np.asarray(jbp.dense_to_words(jnp.asarray(dense), **kw))
    got = tbp.dense_to_words(torch.from_numpy(dense), **kw)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, jbp.pack_bits_to_words_np(bits, **kw))


@pytest.mark.parametrize("r", [8, 16])
@pytest.mark.parametrize("nb", [4, 5, 16])
def test_pack_words_narrow(r, nb, rng):
    words = jbp.pack_bits_to_words_np(_bits(rng, 33, nb, r), num_bands=nb, rows_per_band=r)
    want = np.asarray(jbp.pack_words_narrow(jnp.asarray(words), num_bands=nb, rows_per_band=r))
    got = tbp.pack_words_narrow(tbp.as_words(words, "cpu"), num_bands=nb, rows_per_band=r)
    np.testing.assert_array_equal(_u32(got), want)
    assert (want[0, 0] >> 31) == 1


@pytest.mark.parametrize("r", ROWS)
def test_band_bytes_round_trip(r, rng):
    nb = 5
    row = jbp.pack_bits_to_words_np(_bits(rng, 1, nb, r), num_bands=nb, rows_per_band=r)[0]
    bands = tbp.words_to_band_bytes(row, num_bands=nb, rows_per_band=r)
    assert bands == jbp.words_to_band_bytes(row, num_bands=nb, rows_per_band=r)
    np.testing.assert_array_equal(
        tbp.band_bytes_to_words(bands, rows_per_band=r),
        jbp.band_bytes_to_words(bands, rows_per_band=r),
    )


def test_word_views_round_trip(rng):
    words = rng.integers(0, 2**32, (7, 3), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0xFFFFFFFF
    t = tbp.as_words(words, "cpu")
    assert t.dtype == torch.int32 and int(t[0, 0]) == -1
    np.testing.assert_array_equal(tbp.words_to_numpy(t), words)
    np.testing.assert_array_equal(tbp.words_to_numpy(tbp.as_words(t.view(torch.uint32), "cpu")), words)
    with pytest.raises(TypeError):
        tbp.as_words(words.astype(np.int64), "cpu")
