"""Grouped collision top-k: the port's core against the JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import scan as jscan
from lshrs_tpu.ops.bitpack import narrow_refine_r
from lshrs_tpu.ops.bitpack import pack_words_narrow as j_pack_narrow
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.ops.bitpack import pack_words_narrow as t_pack_narrow

C, Q, GROUP, CHUNK = 1024, 12, 64, 256


def _store(rng, num_bands, rows, dim=16, n=700):
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=5)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    sig_rows = np.zeros((C, words.shape[1]), np.uint32)
    sig_rows[:n] = words
    ids = np.full(C, -1, np.int32)
    ids[:n] = rng.permutation(50_000)[:n]
    ids[:n][rng.random(n) < 0.1] = -1  # tombstones
    qx = X[rng.integers(0, n, Q)] + 0.1 * rng.standard_normal((Q, dim)).astype(np.float32)
    qwords = h.hash_batch_words_host(qx)
    qwords[0] = words[3]  # one exact self-match
    return h, sig_rows, ids, qwords


def _jax_rows(sig_rows, ids, tie, *, num_bands, narrow_r, strided_chunk):
    words = jnp.asarray(sig_rows)
    if narrow_r:
        words = j_pack_narrow(words, num_bands=num_bands, rows_per_band=narrow_r)
    ext = jnp.concatenate(
        [
            words,
            jax.lax.bitcast_convert_type(tie, jnp.uint32)[:, None],
            jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.uint32)[:, None],
        ],
        axis=1,
    )
    return jscan.build_grouped_refine_rows(ext, group=GROUP, strided_chunk=strided_chunk)


def _torch_rows(sig_rows, ids, tie, *, num_bands, narrow_r):
    words = torch.from_numpy(sig_rows.view(np.int32).copy())
    if narrow_r:
        words = t_pack_narrow(words, num_bands=num_bands, rows_per_band=narrow_r)
    ext = torch.cat([words, tie[:, None], torch.from_numpy(ids)[:, None]], dim=1)
    return tscan.build_grouped_refine_rows(ext, group=GROUP)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("num_bands,rows,probes,k,narrow", [
    (4, 8, 1, 12, False), (4, 8, 1, 12, True),
    (16, 16, 1, 10, False), (16, 16, 1, 10, True),
    (2, 40, 1, 5, False),  # two words per band, no narrow packing
    (4, 8, 2, 12, False), (4, 8, 2, 12, True),
    (4, 8, 1, 1100, True),  # k past the candidate pool: padded
])
def test_collision_core_matches_jax(num_bands, rows, probes, k, narrow, use_pallas, rng):
    narrow_r = narrow_refine_r(rows) if narrow else 0
    assert bool(narrow_r) == narrow
    h, sig_rows, ids, qwords = _store(rng, num_bands, rows)
    if probes > 1:  # probe 1 flips bit 0 of every band (pairwise distinct)
        qwords = np.concatenate([qwords, qwords ^ np.uint32(1)], axis=1)
    tie_j = jscan.compute_global_tie(jnp.asarray(ids))
    j_counts, j_ids = jscan.collision_topk_grouped(
        jnp.asarray(np.ascontiguousarray(sig_rows.T)), jnp.asarray(ids), tie_j,
        jnp.asarray(qwords),
        num_bands=num_bands, k=k, group=GROUP, pallas_chunk=CHUNK, q_tile=8,
        use_pallas=use_pallas, interpret=use_pallas,
        sig_rows=_jax_rows(sig_rows, ids, tie_j, num_bands=num_bands, narrow_r=narrow_r,
                           strided_chunk=CHUNK if use_pallas else None),
        narrow_r=narrow_r, probes=probes,
    )

    tie_t = tscan.global_tie_core(torch.from_numpy(ids))
    np.testing.assert_array_equal(tie_t.numpy(), np.asarray(tie_j))
    t_counts, t_ids = tscan.collision_topk_grouped_core(
        torch.from_numpy(np.ascontiguousarray(sig_rows.T).view(np.int32)), tie_t,
        torch.from_numpy(qwords.view(np.int32)),
        _torch_rows(sig_rows, ids, tie_t, num_bands=num_bands, narrow_r=narrow_r),
        num_bands=num_bands, k=k, group=GROUP, narrow_r=narrow_r, probes=probes,
    )
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert t_counts[0, 0] == num_bands  # the planted self-match
    assert (t_counts.numpy() > 0).sum() > 2  # not a vacuous comparison


def test_global_tie_with_duplicate_ids(rng):
    ids = rng.integers(0, 40, 512).astype(np.int32)  # many duplicate ids
    ids[rng.random(512) < 0.2] = -1
    got = tscan.global_tie_core(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jscan.compute_global_tie(jnp.asarray(ids))))
    assert len(set(got[got >= 0].tolist())) == int((ids >= 0).sum())  # alive ties distinct


def test_merge_topk_pools_matches_jax(rng):
    counts = rng.integers(0, 4, (6, 40)).astype(np.int32)
    ids = rng.integers(0, 30, (6, 40)).astype(np.int32)
    for k in (5, 40, 50):
        jc, ji = jscan.merge_topk_pools(jnp.asarray(counts), jnp.asarray(ids), k=k)
        tc, ti = tscan.merge_topk_pools(torch.from_numpy(counts), torch.from_numpy(ids), k=k)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_grouped_refine_rows_match_jax_contiguous(rng):
    ext = rng.integers(0, 2**32, (256, 5), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jscan.build_grouped_refine_rows(jnp.asarray(ext), group=32, strided_chunk=None))
    got = tscan.build_grouped_refine_rows(torch.from_numpy(ext.view(np.int32)), group=32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
