"""Asymmetric SimHash ranking: quantised query coordinates against the
store's sign bitplanes.

Symmetric Hamming ranking (`lshrs_tpu_torch.ops.hamming`) reduces both
sides of the SimHash estimator to sign bits. Only the store side has to
be: the query keeps its projection coordinates, and

    s(q, x) = sum_j  c_j(q) * sign(p_j . x)        c_j(q) = p_j . q

ranks with a strictly better correlation to cosine at the same store
memory; ``s / sum_j |c_j|`` estimates ``cos(theta)``.

Formulation (the same int8 kernel as symmetric Hamming, B2):

- the query coordinates are quantised per row to int8
  (``rint(c * qmax / max|c_row|)``; ``qmax`` 127, or 7 for the half-byte
  wire of :func:`pack_coords_int4_np`);
- kernel B2 scores every slot with the int8 dot against the ±1 planes and
  packs ``((dot + offset) >> shift) * scale + tie`` with ``offset = P *
  qmax`` and ``shift = asymmetric_shift(P, C, qmax)``, so the key fits a
  positive int32 at every capacity; the top-k groups by max hold every
  top-k slot of the SHIFTED score;
- the candidate pool (``k`` groups) is re-ranked by the exact
  ``(dot desc, id asc)`` order, the dots rebuilt from the packed words
  (:func:`refine_dots_from_words`), so reported scores are exact. A true
  top-k slot can be displaced only by one whose shifted key ties it: a
  dot gap under ``2**shift`` (32 of ±32512 at 2**20 slots).

The chunked core (:func:`asymmetric_topk_chunked_core`) takes the stores
whose capacity is not a multiple of the group, as the reference's does:
keys ``(dots + offset + 1) * chunk + (chunk - 1 - rank)`` with each slot's
id rank within its chunk, which pack into int32 with no shift, so its
order is the exact ``(dots desc, id asc)``.
"""

from __future__ import annotations

import numpy as np
import torch

from lshrs_tpu_torch.ops.group_max import asymmetric_shift, hamming_group_max_keys, key_scale
from lshrs_tpu_torch.ops.hamming import int8_dots
from lshrs_tpu_torch.ops.scan import (
    chunk_key_terms,
    chunk_step,
    chunked_topk_scan,
    gather_refine,
    select_top_groups,
)
from lshrs_tpu_torch.utils.trace import span

__all__ = [
    "QMAX",
    "QMAX4",
    "asymmetric_shift",
    "asymmetric_topk_chunked_core",
    "asymmetric_topk_core",
    "pack_coords_int4_np",
    "quantize_coords",
    "quantize_coords_np",
    "refine_dots_from_words",
    "unpack_coords_int4",
]

QMAX = 127  # int8 range of the quantised query coordinates
QMAX4 = 7  # int4 range of the half-byte wire (pack_coords_int4_np)

# Elements of the (queries, candidates, bits) operand of the refine's
# product per step (~0.5 GB of float32).
_REFINE_STEP_ELEMENTS = 1 << 27


def quantize_coords_np(coords: np.ndarray, qmax: int = QMAX) -> tuple[np.ndarray, np.ndarray]:
    """Per-row int8 quantisation of query projection coordinates.

    Returns ``(q_i8 (n, P) int8, sum_abs (n,) int32)``; the cosine
    estimate of a dot ``d`` against the ±1 planes is ``d / sum_abs``. Zero
    rows quantise to zeros.
    """
    c = np.asarray(coords, dtype=np.float32)
    m = np.max(np.abs(c), axis=1, keepdims=True)
    s = np.divide(qmax, m, out=np.zeros_like(m), where=m > 0)
    qi8 = np.rint(c * s).astype(np.int8)
    sumabs = np.abs(qi8.astype(np.int32)).sum(axis=1)
    return qi8, sumabs


def quantize_coords(coords: torch.Tensor, qmax: int = QMAX) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch twin of :func:`quantize_coords_np` (the same ``rint``: round
    half to even, on float32)."""
    c = coords.to(torch.float32)
    m = c.abs().amax(dim=1, keepdim=True)
    s = torch.where(m > 0, qmax / m, torch.zeros_like(m))
    qi8 = torch.round(c * s).to(torch.int8)
    return qi8, qi8.to(torch.int32).abs().sum(dim=1, dtype=torch.int32)


def pack_coords_int4_np(qi8: np.ndarray) -> np.ndarray:
    """Two int4-range coordinates per byte: ``(n, P)`` int8 -> ``(n, P/2)``
    uint8, the even column in the low nibble, the odd one in the high."""
    q = np.asarray(qi8, dtype=np.int8)
    if q.ndim != 2 or q.shape[1] % 2:
        raise ValueError("coords must be (n, P) with even P")
    if np.abs(q.astype(np.int32)).max(initial=0) > QMAX4:
        raise ValueError(
            f"int4 packing requires coords in [-{QMAX4}, {QMAX4}]; quantise with qmax={QMAX4}"
        )
    u = q.view(np.uint8) & 0xF
    return (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)


def unpack_coords_int4(wire: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`pack_coords_int4_np`: ``(n, P/2)`` uint8 ->
    ``(n, P)`` int8 in ``[-QMAX4, QMAX4]``. The nibbles are taken in int16
    (uint8 shifts are not on every torch backend) and sign-extended by
    ``(v ^ 8) - 8``."""
    u = wire.to(torch.int16)
    lo = ((u & 0xF) ^ 8) - 8
    hi = (((u >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(u.shape[0], -1).to(torch.int8)


def _exact_pool_order(
    dots: torch.Tensor, cand_ids: torch.Tensor, alive: torch.Tensor, k: int, offset: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact ``(dots desc, id asc)`` order of a candidate pool.

    One int64 key ``-dots << 32 | id`` (ids are in ``[0, 2**31)``) sorts
    alive candidates lexicographically; dead ones take the largest key.
    Returns ``(dots (Q, k), ids (Q, k))``; empty entries carry id -1 and
    dots ``-(offset + 1)``.
    """
    q, n = dots.shape
    dead = torch.iinfo(torch.int64).max
    key = torch.where(alive, (-dots.to(torch.int64) << 32) | cand_ids.to(torch.int64), dead)
    k_eff = min(k, n)
    top = torch.topk(key, k_eff, dim=1, largest=False, sorted=True).values
    valid = top != dead
    out_ids = torch.where(valid, top & 0xFFFFFFFF, -1).to(torch.int32)
    out_dots = torch.where(valid, -(top >> 32), -(offset + 1)).to(torch.int32)
    if k_eff < k:
        out_ids = torch.nn.functional.pad(out_ids, (0, k - k_eff), value=-1)
        out_dots = torch.nn.functional.pad(out_dots, (0, k - k_eff), value=-(offset + 1))
    return out_dots, out_ids


def _coord_positions(num_bands: int, rows_per_band: int, narrow_r: int) -> list[int]:
    """Bit position (``word * 32 + bit``) of each signature coordinate in a
    gathered refine row: word-aligned bands, or ``32 // narrow_r`` bands
    per word."""
    pos = []
    for b in range(num_bands):
        for ri in range(rows_per_band):
            if narrow_r:
                bpw = 32 // narrow_r
                pos.append((b // bpw) * 32 + (b % bpw) * narrow_r + ri)
            else:
                wpb = -(-rows_per_band // 32)
                pos.append((b * wpb + ri // 32) * 32 + ri % 32)
    return pos


def refine_dots_from_words(
    cwords: torch.Tensor,
    qcoords: torch.Tensor,
    *,
    num_bands: int,
    rows_per_band: int,
    narrow_r: int = 0,
) -> torch.Tensor:
    """Exact asymmetric dots of gathered candidate words vs query coords.

    ``dot = sum_j c_j (2 b_j - 1) = 2 sum_j c_j b_j - sum_j c_j``: the
    coordinates are scattered to the bit positions of the gathered words,
    the candidates' bits unpacked to 0/1, and ``sum_j c_j b_j`` taken as a
    batched float32 product. Every partial sum is an integer of magnitude
    at most ``P * 127 < 2**24`` and every operand a small integer, exact
    in float32 (and in TF32), so the dots are exact.

    Args:
        cwords: ``(Q, m, nw, group)`` int32 gathered words, word-aligned
            when ``narrow_r == 0``, else narrow-packed.
        qcoords: ``(Q, Pq)`` int8 quantised coordinates; columns past
            ``num_bands * rows_per_band`` (padding) are ignored.

    Returns:
        ``(Q, m, group)`` int32 exact dots, as against ±1 bitplanes.
    """
    q, m, nw, group = cwords.shape
    p = num_bands * rows_per_band
    c32 = qcoords[:, :p].to(torch.int32)
    csum = c32.sum(dim=1, dtype=torch.int32)
    pos = torch.tensor(
        _coord_positions(num_bands, rows_per_band, narrow_r), device=cwords.device
    )
    coef = torch.zeros((q, nw * 32), dtype=torch.float32, device=cwords.device)
    coef[:, pos] = c32.to(torch.float32)
    shifts = torch.arange(32, dtype=torch.int32, device=cwords.device)
    step = max(1, _REFINE_STEP_ELEMENTS // (m * group * nw * 32))
    acc = torch.empty((q, m * group), dtype=torch.int32, device=cwords.device)
    for s in range(0, q, step):
        w = cwords[s : s + step].permute(0, 1, 3, 2).reshape(-1, m * group, nw, 1)
        # (word >> bit) & 1 is the bit even under int32's arithmetic shift.
        bits = ((w >> shifts) & 1).to(torch.float32).reshape(-1, m * group, nw * 32)
        acc[s : s + step] = torch.bmm(bits, coef[s : s + step, :, None])[..., 0].to(torch.int32)
    return (2 * acc - csum[:, None]).reshape(q, m, group)


def asymmetric_topk_core(
    planes: torch.Tensor,
    tie: torch.Tensor,
    qcoords: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    num_bands: int,
    rows_per_band: int,
    k: int,
    group: int,
    shift: int,
    qmax: int = QMAX,
    narrow_r: int = 0,
    sig_t: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by (asymmetric dot desc, id asc), grouped path (kernel B2).

    Args:
        planes: ``(C, Pp)`` int8 ±1 store bitplanes, zero past the
            signature's ``P = num_bands * rows_per_band`` columns.
        tie: ``(C,)`` int32 global tie keys (-1 dead).
        qcoords: ``(Q, Pp)`` int8 quantised coordinates, zero-padded like
            ``planes``.
        sig_rows: grouped refine table (narrow-packed when ``narrow_r``);
            ``None`` gathers the candidates slot by slot from ``tie`` and
            ``ids`` (a ``where=`` filter).
        sig_t: ``(BW, C)`` packed words (always: the table's word count
            and the per-slot gather read it).
        shift: key right-shift, :func:`asymmetric_shift` of ``(P, C,
            qmax)``.

    Returns:
        ``(dots (Q, k) int32, ids (Q, k) int32)``; empty tail entries
        carry id -1 and dots ``-(P * qmax + 1)``.
    """
    c = planes.shape[0]
    p = num_bands * rows_per_band
    offset = p * qmax
    gmax = hamming_group_max_keys(
        planes, tie, qcoords, group=group, scale=key_scale(c),
        offset=offset, shift=shift, num_perm=p,
    )
    top_groups = select_top_groups(gmax, min(k, c // group))
    del gmax
    q = qcoords.shape[0]
    with span("lshrs.refine"):
        cwords, cand_tie, cand_ids, narrow_r = gather_refine(
            sig_rows, sig_t, tie, ids, top_groups,
            num_bands=num_bands, group=group, narrow_r=narrow_r,
        )
        dots = refine_dots_from_words(
            cwords, qcoords, num_bands=num_bands, rows_per_band=rows_per_band,
            narrow_r=narrow_r,
        ).reshape(q, -1)
    with span("lshrs.topk"):
        return _exact_pool_order(
            dots, cand_ids.reshape(q, -1), cand_tie.reshape(q, -1) >= 0, k, offset
        )


def asymmetric_topk_chunked_core(
    planes: torch.Tensor,
    ids: torch.Tensor,
    ranks: torch.Tensor,
    qcoords: torch.Tensor,
    *,
    k: int,
    chunk: int,
    qmax: int = QMAX,
    num_perm: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by (asymmetric dot desc, id asc), chunked selection (the
    fallback where the capacity is not a multiple of the group).

    The key ``(dots + offset + 1) * chunk + (chunk - 1 - rank)``, ``offset
    = P * qmax``, packs into int32 with no shift (at chunk 2048 and
    ``P * qmax = 32512``), so the order is exact in the unquantised dots.

    Args:
        planes: ``(C, Pp)`` int8 +-1 store bitplanes, zero past ``num_perm``
            columns; C a multiple of ``chunk``.
        ids / ranks: ``(C,)`` int32 slot ids (-1 dead) and id ranks within
            each chunk (`lshrs_tpu_torch.ops.scan.compute_chunk_ranks`).
        qcoords: ``(Q, Pp)`` int8 quantised coordinates, zero-padded like
            ``planes``.
        num_perm: signature bits P (default ``Pp``).

    Returns:
        ``(dots (Q, k) int32, ids (Q, k) int32)``; empty tail entries carry
        id -1 and dots ``-(P * qmax + 1)``.
    """
    p = planes.shape[1] if num_perm is None else num_perm
    offset = p * qmax
    if (2 * offset + 2) * chunk >= 2**31:
        raise ValueError(
            f"chunk {chunk} too wide for exact asymmetric packing at "
            f"num_perm*qmax={offset}"
        )
    q = qcoords.shape[0]
    mult, bias = chunk_key_terms(ids, ranks, mult=chunk, bias=(offset + 1) * chunk, chunk=chunk)

    def keys(s: int, e: int) -> torch.Tensor:
        return torch.addcmul(bias[None, s:e], int8_dots(qcoords, planes[s:e]), mult[None, s:e])

    scaled, out_ids = chunked_topk_scan(keys, ids, q=q, k=k, chunk=chunk, step=chunk_step(q, chunk))
    return torch.where(out_ids >= 0, scaled - offset - 1, -(offset + 1)), out_ids
