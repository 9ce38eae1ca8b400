"""Bucketed query engine: sorted band keys + binary search, plain PyTorch.

The reference's Redis bucket tables (``(band, signature) -> set of ids``)
are materialised as per-band sorted key arrays:

    keys[b, :]   folded band-b signature of every slot (a 32-bit value,
                 held in int64 so that it sorts unsigned)
    order[b, :]  slots permuted so keys[b, order[b]] ascends
    skeys[b, :]  the sorted keys themselves

A query then runs with static shapes:

    1. ``torch.searchsorted`` per band over the ``(B, C)`` sorted rows ->
       the start of the matching key run,
    2. a fixed window of ``bucket_cap`` slots per band (runs longer than
       the window are truncated and *counted*: the overflow statistic),
    3. candidates deduplicated (sort + first-occurrence mask),
    4. **verification**: the candidates' band words are gathered and the
       exact per-band collision counts recomputed, so folded-key
       collisions (W > 1 words per band fold to 32 bits) never corrupt
       results,
    5. exact (count desc, id asc) top-k on the packed (count, id-rank) key
       the scan engine uses.

Cost per query is O(num_bands * (log C + bucket_cap * BW)), against the
scan's O(C * BW). Results equal the scan engine's whenever no bucket run
exceeds ``bucket_cap``. The reference computes all of this in plain
``jnp`` (`lshrs_tpu/ops/bucketed.py`), outside any Pallas kernel, so
plain torch on the card is its port; the search, gathers and sorts are
PyTorch's own kernels.

Words are int32 bit-views of the uint32 signature words. The fold runs
in int64 with every product masked to 32 bits (the multiply is split in
16-bit halves so no int64 product overflows), giving the reference's
wrapped uint32 arithmetic exactly.
"""

from __future__ import annotations

import torch

from lshrs_tpu_torch.ops.group_max import key_scale

__all__ = ["bucketed_slice_queries", "bucketed_topk", "build_bucket_index", "fold_band_keys"]

_MASK32 = 0xFFFFFFFF
_MIX = 2654435761  # Knuth's multiplicative constant
_DEAD_KEY = 0xFFFFFFFF

# Working set of one query slice: its (Q, B * L) candidate columns
# (windows, slots, sorted slots and their sort indices, keys, counts and a
# band's word gather; ~80 bytes per column) stay near this many bytes.
_SLICE_BYTES = 1 << 30
_BYTES_PER_CANDIDATE = 80


def _mul_mix(k: torch.Tensor) -> torch.Tensor:
    """``(k * _MIX) mod 2**32`` for int64 ``k`` in ``[0, 2**32)``: the
    product split at 16 bits so every partial product fits int64."""
    lo = k & 0xFFFF
    hi = k >> 16
    return (lo * _MIX + (((hi * _MIX) & 0xFFFF) << 16)) & _MASK32


def fold_band_keys(sig_t: torch.Tensor, *, num_bands: int) -> torch.Tensor:
    """Fold each band's W words into one 32-bit bucket key, ``(B, C)``
    int64 holding the unsigned value."""
    bw, c = sig_t.shape
    w = bw // num_bands
    banded = sig_t.reshape(num_bands, w, c).to(torch.int64) & _MASK32
    keys = banded[:, 0, :]
    for j in range(1, w):
        keys = _mul_mix(keys) ^ banded[:, j, :]
    return keys


def build_bucket_index(
    sig_t: torch.Tensor, ids: torch.Tensor, *, num_bands: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted per-band bucket index: ``(skeys (B, C) int64, order (B, C)
    int64)``.

    Dead slots get the largest key, so they cluster at the tail (and are
    dropped again during verification). The argsort is stable, like the
    reference's, so the slots inside an overflowing run (and hence the
    truncated results) are the reference's.
    """
    keys = fold_band_keys(sig_t, num_bands=num_bands)
    keys = torch.where(ids[None, :] >= 0, keys, _DEAD_KEY)
    order = torch.argsort(keys, dim=1, stable=True)
    return keys.gather(1, order), order


def bucketed_slice_queries(*, num_bands: int, bucket_cap: int) -> int:
    """Queries per slice of :func:`bucketed_topk`, so that each slice's
    candidate columns stay near `_SLICE_BYTES`. The reference jits the
    whole batch: at Q=16,384, 16 bands and ``bucket_cap=128`` its
    candidate words alone are ``(16, Q, 2048)`` int32, 2 GiB."""
    return max(1, _SLICE_BYTES // (num_bands * bucket_cap * _BYTES_PER_CANDIDATE))


def _bucketed_slice(sig_t, ids, tie, skeys, order, qwords, *, num_bands, k, bucket_cap):
    bw, c = sig_t.shape
    w = bw // num_bands
    q = qwords.shape[0]
    scale = key_scale(c)
    dev = sig_t.device
    lcap = bucket_cap  # L, the window per (query, band)

    qkeys = fold_band_keys(qwords.T, num_bands=num_bands)  # (B, Q)

    # 1. batched binary search per band (side="left")
    lo = torch.searchsorted(skeys, qkeys.contiguous(), right=False).T  # (Q, B)

    # 2. fixed windows of candidate slots
    win = lo[:, :, None] + torch.arange(lcap, device=dev)  # (Q, B, L)
    band_base = (torch.arange(num_bands, device=dev) * c)[None, :, None]
    flat = (band_base + win.clamp(max=c - 1)).reshape(-1)
    qk = qkeys.T[:, :, None]
    hit = (skeys.reshape(-1)[flat].reshape(q, num_bands, lcap) == qk) & (win < c)
    slots = order.reshape(-1)[flat].reshape(q, num_bands, lcap)
    slots = torch.where(hit, slots, c)  # c = sentinel for misses

    # overflow: does the run continue past the window?
    past = (lo + lcap).clamp(max=c - 1)
    past_key = skeys.reshape(-1)[(band_base[:, :, 0] + past).reshape(-1)].reshape(q, num_bands)
    overflows = ((past_key == qkeys.T) & (lo + lcap < c)).sum()

    # 3. deduplicate candidates per query (sort + first-occurrence mask)
    cand = torch.sort(slots.reshape(q, num_bands * lcap), dim=1).values
    first = torch.ones_like(cand, dtype=torch.bool)
    first[:, 1:] = cand[:, 1:] != cand[:, :-1]
    cand = torch.where(first, cand, c)  # c = dropped (misses sort last)

    # 4. verification: exact band counts of the gathered candidates
    n_cand = cand.shape[1]
    safe = cand.clamp(max=c - 1)
    counts = torch.zeros((q, n_cand), dtype=torch.int32, device=dev)
    for b in range(num_bands):
        eq = sig_t[b * w][safe] == qwords[:, b * w, None]
        for j in range(1, w):
            eq &= sig_t[b * w + j][safe] == qwords[:, b * w + j, None]
        counts += eq
    cand_tie = tie[safe]
    alive = (cand_tie >= 0) & (cand < c)
    key = torch.where(alive, counts * scale + cand_tie, 0)

    # 5. exact selection: live keys are distinct; every key that is not
    # (count 0 or dropped) decodes to id -1 whatever order topk gives it.
    k_eff = min(k, n_cand)
    top_key, top_pos = torch.topk(key, k_eff, dim=1)
    sel_counts = top_key // scale
    sel_ids = torch.where(sel_counts > 0, ids[safe.gather(1, top_pos)], -1)
    if k_eff < k:
        sel_counts = torch.nn.functional.pad(sel_counts, (0, k - k_eff))
        sel_ids = torch.nn.functional.pad(sel_ids, (0, k - k_eff), value=-1)
    return sel_counts, sel_ids, overflows


def bucketed_topk(
    sig_t: torch.Tensor,
    ids: torch.Tensor,
    tie: torch.Tensor,
    skeys: torch.Tensor,
    order: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    k: int,
    bucket_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k via bucket enumeration + verification.

    Args:
        sig_t / ids / tie: store state (see `lshrs_tpu_torch.storage.device`).
        skeys / order: output of :func:`build_bucket_index`.
        qwords: ``(Q, BW)`` int32 query words.
        bucket_cap: most slots taken per (query, band) bucket run.

    The queries go through in slices of :func:`bucketed_slice_queries`;
    the result does not depend on the slicing.

    Returns:
        ``(counts (Q, k) int32, ids (Q, k) int32, overflows ())``: exact
        (count desc, id asc) results, and the number of (query, band)
        bucket runs longer than ``bucket_cap`` (0 means the results equal
        the full scan's).
    """
    dev_batch = bucketed_slice_queries(num_bands=num_bands, bucket_cap=bucket_cap)
    kw = dict(num_bands=num_bands, k=k, bucket_cap=bucket_cap)
    parts = [
        _bucketed_slice(sig_t, ids, tie, skeys, order, qwords[s : s + dev_batch], **kw)
        for s in range(0, qwords.shape[0], dev_batch)
    ]
    if len(parts) == 1:
        return parts[0]
    return (
        torch.cat([p[0] for p in parts]),
        torch.cat([p[1] for p in parts]),
        torch.stack([p[2] for p in parts]).sum(),
    )
