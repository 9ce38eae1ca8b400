"""Grouped Hamming top-k: the port's core against the JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import hamming as jham
from lshrs_tpu.ops import scan as jscan
from lshrs_tpu.ops.bitpack import narrow_refine_r
from lshrs_tpu.ops.bitpack import pack_words_narrow as j_pack_narrow
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.ops.bitpack import pack_words_narrow as t_pack_narrow

C, Q, GROUP, CHUNK = 1024, 12, 64, 256


def _case(rng, num_bands, rows, dim=16, n=700):
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=7)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    sig_rows = np.zeros((C, words.shape[1]), np.uint32)
    sig_rows[:n] = words
    ids = np.full(C, -1, np.int32)
    ids[:n] = rng.permutation(50_000)[:n]
    ids[:n][rng.random(n) < 0.1] = -1
    qx = X[rng.integers(0, n, Q)] + 0.3 * rng.standard_normal((Q, dim)).astype(np.float32)
    return sig_rows, ids, h.hash_batch_words_host(qx)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("num_bands,rows,k,narrow", [
    (4, 16, 10, False), (4, 16, 10, True), (8, 8, 3, True), (2, 40, 10, False),
    (4, 16, 1100, True),  # k past the candidate pool: padded
])
def test_hamming_core_matches_jax(num_bands, rows, k, narrow, use_pallas, rng):
    narrow_r = narrow_refine_r(rows) if narrow else 0
    assert bool(narrow_r) == narrow
    sig_rows, ids, qwords = _case(rng, num_bands, rows)
    kw = dict(num_bands=num_bands, rows_per_band=rows)

    planes_j = jham.unpack_bitplanes(jnp.asarray(sig_rows), **kw)
    qbits_j = jham.unpack_bitplanes(jnp.asarray(qwords), **kw)
    tie_j = jscan.compute_global_tie(jnp.asarray(ids))
    words_j = jnp.asarray(sig_rows)
    if narrow_r:
        words_j = j_pack_narrow(words_j, num_bands=num_bands, rows_per_band=narrow_r)
    ext_j = jnp.concatenate([
        words_j,
        jax.lax.bitcast_convert_type(tie_j, jnp.uint32)[:, None],
        jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.uint32)[:, None],
    ], axis=1)
    j_ham, j_ids = jham.hamming_topk(
        planes_j, jnp.asarray(np.ascontiguousarray(sig_rows.T)), jnp.asarray(ids), tie_j,
        qbits_j, jnp.asarray(qwords),
        k=k, chunk=CHUNK, group=GROUP, use_pallas=use_pallas, q_tile=8,
        interpret=use_pallas,
        sig_rows=jscan.build_grouped_refine_rows(
            ext_j, group=GROUP, strided_chunk=CHUNK if use_pallas else None
        ),
        narrow_r=narrow_r,
    )

    words_t = torch.from_numpy(sig_rows.view(np.int32).copy())
    planes_t = tham.unpack_bitplanes(words_t, **kw)
    np.testing.assert_array_equal(planes_t.numpy(), np.asarray(planes_j))
    qw_t = torch.from_numpy(qwords.view(np.int32).copy())
    qbits_t = tham.unpack_bitplanes(qw_t, **kw)
    tie_t = tscan.global_tie_core(torch.from_numpy(ids))
    if narrow_r:
        words_t = t_pack_narrow(words_t, num_bands=num_bands, rows_per_band=narrow_r)
    ext_t = torch.cat([words_t, tie_t[:, None], torch.from_numpy(ids)[:, None]], dim=1)
    t_ham, t_ids = tham.hamming_topk_core(
        planes_t, tie_t, qbits_t, qw_t, tscan.build_grouped_refine_rows(ext_t, group=GROUP),
        k=k, group=GROUP, narrow_r=narrow_r,
    )
    np.testing.assert_array_equal(t_ham.numpy(), np.asarray(j_ham))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert (t_ids.numpy()[:, 0] >= 0).all()


def test_popcount32_matches_numpy(rng):
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(1)
    got = tham.popcount32(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity", [1 << 10, 1 << 20, 1 << 22, 1 << 23])
@pytest.mark.parametrize("num_perm", [64, 256])
def test_supports_hamming_grouped_matches(num_perm, capacity):
    assert tham.supports_hamming_grouped(num_perm, capacity) == jham.supports_hamming_grouped(
        num_perm, capacity
    )
