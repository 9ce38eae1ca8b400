"""Hamming-distance ranking over full signatures (the bitplane query mode).

Band-collision counting quantises each band to hit/miss; this mode ranks
candidates by the Hamming distance between whole ``num_perm``-bit
signatures, the SimHash angular estimator. Two storages give the same
results bit for bit:

    "planes": signatures as +-1 int8 bitplanes (C, num_perm), num_perm
              bytes per slot; dots = qbits . planes, kernel B2,
              dot = P - 2 * hamming
    "packed": XOR + popcount over the packed words the collision scan
              already stores, zero extra bytes; kernel B3
    select by (hamming asc, id asc)    packed keys + contiguous group max,
                                       top-k groups, popcount-exact refine

Selection reuses the group-max exactness argument of the collision scan
(`lshrs_tpu_torch.ops.scan`): keys embed each slot's global id-rank, so
alive keys are distinct, and the top-k groups by max hold every true
top-k slot. The refine stage recomputes those candidates' distances from
the packed words (XOR + popcount), gathered from the grouped refine table.

Not ported yet: the refinement cascade, the chunked fallbacks and the
two-key selection past the int32 key ceiling (ROADMAP Queue A).
"""

from __future__ import annotations

import torch

from lshrs_tpu_torch.ops.bitpack import narrow_words_count, pack_words_narrow, popcount32
from lshrs_tpu_torch.ops.group_max import (
    hamming_group_max_keys,
    hamming_packed_group_max_keys,
    key_scale,
)
from lshrs_tpu_torch.ops.scan import gather_refine_group_rows

__all__ = [
    "hamming_topk_core",
    "hamming_topk_packed_core",
    "popcount32",
    "supports_hamming_grouped",
    "unpack_bitplanes",
]


def supports_hamming_grouped(num_perm: int, capacity: int) -> bool:
    """True when the (scaled-dot, tie) key packs into a positive int32."""
    return (num_perm + 2) * key_scale(capacity) < 2**31


def unpack_bitplanes(
    words: torch.Tensor, *, num_bands: int, rows_per_band: int
) -> torch.Tensor:
    """Packed int32 signature words -> +-1 int8 bitplanes.

    Args:
        words: ``(n, num_bands * W)`` int32 (see `lshrs_tpu_torch.ops.bitpack`).
    Returns:
        ``(n, num_bands * rows_per_band)`` int8 in {-1, +1}, bit order
        matching the packing (band-major, row-minor).
    """
    n = words.shape[0]
    w = words.shape[1] // num_bands
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    # (word >> s) & 1 is bit s even under the arithmetic shift of int32.
    bits = (words.reshape(n, num_bands, w, 1) >> shifts) & 1
    bits = bits.reshape(n, num_bands, w * 32)[:, :, :rows_per_band]
    return (2 * bits - 1).to(torch.int8).reshape(n, num_bands * rows_per_band)


def hamming_topk_core(
    planes: torch.Tensor,
    tie: torch.Tensor,
    qbits: torch.Tensor,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor,
    *,
    k: int,
    group: int,
    narrow_r: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc), grouped bitplane path.

    Args:
        planes: ``(C, P)`` int8 store bitplanes (dead slots arbitrary).
        tie: ``(C,)`` int32 global tie keys (-1 dead).
        qbits / qwords: ``(Q, P)`` int8 and ``(Q, BW)`` int32 queries.
        sig_rows: ``(C // group, group * (nw + 2))`` grouped refine table
            (`lshrs_tpu_torch.ops.scan.build_grouped_refine_rows`);
            narrow-packed when ``narrow_r`` is nonzero.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry
        id -1 and hamming P+1.
    """
    c, p = planes.shape
    gmax = hamming_group_max_keys(
        planes, tie, qbits, group=group, scale=key_scale(c)
    )
    return _select_refine(
        gmax, qwords, sig_rows, p=p, k=k, group=group, narrow_r=narrow_r
    )


def hamming_topk_packed_core(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor,
    *,
    num_perm: int,
    k: int,
    group: int,
    narrow_r: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc) from the PACKED words only.

    No bitplane array: kernel B3 scores every slot by XOR + popcount over
    the same ``(BW, C)`` store the collision scan uses. Results equal
    :func:`hamming_topk_core`'s bit for bit.

    Args:
        sig_t: ``(BW, C)`` int32 transposed signatures (dead slots
            arbitrary).
        tie: ``(C,)`` int32 global tie keys (-1 dead).
        qwords: ``(Q, BW)`` int32 query words.
        sig_rows: grouped refine table, as for :func:`hamming_topk_core`.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry
        id -1 and hamming P+1.
    """
    gmax = hamming_packed_group_max_keys(
        sig_t, tie, qwords, num_perm=num_perm, group=group,
        scale=key_scale(sig_t.shape[1]),
    )
    return _select_refine(
        gmax, qwords, sig_rows, p=num_perm, k=k, group=group, narrow_r=narrow_r
    )


def _select_refine(gmax, qwords, sig_rows, *, p, k, group, narrow_r=0):
    """Hamming selection tail: top-k groups by max, popcount-exact refine
    from the gathered packed words, exact (hamming, id) order.

    ``narrow_r`` nonzero means ``sig_rows`` is narrow-packed. Popcount is
    layout-agnostic — the narrow words hold exactly the same set bits — so
    only the word count and the query packing change.
    """
    q, ng = gmax.shape
    scale = key_scale(ng * group)
    if (p + 2) * scale >= 2**31:
        raise NotImplementedError(
            "Hamming ranking past the int32 key ceiling needs the two-key "
            "selector or int64 keys (ROADMAP Queue A)"
        )
    m = min(k, ng)
    top_groups = torch.topk(gmax, m, dim=1).indices
    bw = qwords.shape[1]
    if narrow_r:
        # narrow packing applies only when words-per-band == 1
        nw = narrow_words_count(bw, narrow_r)
        qcmp = pack_words_narrow(qwords, num_bands=bw, rows_per_band=narrow_r)
    else:
        nw = bw
        qcmp = qwords
    cwords, cand_tie, cand_ids = gather_refine_group_rows(
        sig_rows, top_groups, bw=nw, group=group
    )
    hamming = popcount32(cwords ^ qcmp[:, None, :, None]).sum(2, dtype=torch.int32)
    mg = m * group
    hamming = hamming.reshape(q, mg)
    cand_tie = cand_tie.reshape(q, mg)
    scaled = torch.where(cand_tie >= 0, p + 1 - hamming, 0)
    key = scaled * scale + cand_tie.clamp(min=0)
    k_eff = min(k, mg)
    top_key, top_pos = torch.topk(key, k_eff, dim=1)
    sel_scaled = top_key // scale
    picked = cand_ids.reshape(q, mg).gather(1, top_pos)
    sel_ids = torch.where(sel_scaled > 0, picked, -1)
    out_h = torch.where(sel_scaled > 0, p + 1 - sel_scaled, p + 1)
    if k_eff < k:
        out_h = torch.nn.functional.pad(out_h, (0, k - k_eff), value=p + 1)
        sel_ids = torch.nn.functional.pad(sel_ids, (0, k - k_eff), value=-1)
    return out_h, sel_ids
