"""Hamming-distance ranking over full signatures (the bitplane query mode).

Band-collision counting quantises each band to hit/miss; this mode ranks
candidates by the Hamming distance between whole ``num_perm``-bit
signatures, the SimHash angular estimator. Two storages give the same
results bit for bit:

    "planes": signatures as +-1 int8 bitplanes (C, num_perm), num_perm
              bytes per slot; dots = qbits . planes, kernel B2,
              dot = P - 2 * hamming
    "packed": the packed words the collision scan already stores, zero
              extra bytes; kernel B3 expands them to +-1 tiles on the
              card and scores them as B2 does (popcount in its plain
              version)
    select by (hamming asc, id asc)    packed keys + contiguous group max,
                                       top-k groups, popcount-exact refine

Selection reuses the group-max exactness argument of the collision scan
(`lshrs_tpu_torch.ops.scan`): keys embed each slot's global id-rank, so
alive keys are distinct, and the top-k groups by max hold every true
top-k slot. The refine stage recomputes those candidates' distances from
the packed words (XOR + popcount), gathered from the grouped refine table.
Within its limits one kernel (:func:`hamming_refine_topk`) does the
gather, the popcount and the final top-k in one launch; filtered queries
(no table) and larger pools take the plain stages, its CPU version.

The refinement cascade (:func:`hamming_topk_cascade_core`) runs B2 on a
prefix of the bitplanes, refines a deep pool of groups at full width, and
keys its refine in int64 past the int32 ceiling: it serves stores the
single-pass engines cannot.

Both storages rank exactly in one block or many
(:func:`hamming_topk_blocked_core`): kernel B2 on the bitplanes, or B3 on
the packed words read in place, and the selection tail run on each block
of at most :func:`hamming_block_slots` slots (one block up to 2**22 slots
at 256 bits), keyed by block-local ties that pack into int32, and past
one block one exact merge by ``(hamming asc, id asc)``
(:func:`merge_hamming_pools`, span ``lshrs.merge``) joins the blocks'
lists.

The chunked cores (:func:`hamming_topk_chunked_core` on bitplanes,
:func:`hamming_topk_packed_chunked_core` on packed words) serve the rest
of those stores exactly: stores below the group. Their keys embed each
slot's id rank within its chunk
(`lshrs_tpu_torch.ops.scan.chunked_topk_scan`); the dots are one exact
int8 product per step (:func:`int8_dots`, ``torch._int_mm``). The packed
core unpacks each step's words to +-1 planes over all ``32 * BW`` bits,
where ``hamming = (32 * BW - dot) / 2`` (unused high bits are zero on
both sides and agree), so no bitplane array outlives a step.
"""

from __future__ import annotations

import collections

import torch

from lshrs_tpu_torch.ops.bitpack import narrow_words_count, pack_words_narrow, popcount32
from lshrs_tpu_torch.ops.group_max import (
    _check,
    _device,
    _launch,
    hamming_group_max_keys,
    hamming_packed_group_max_keys,
    key_scale,
)
from lshrs_tpu_torch.ops.scan import (
    chunk_key_terms,
    chunk_step,
    chunked_topk_scan,
    gather_refine_group_rows,
    gather_refine_slots,
    merge_topk_pools,
    select_top_groups,
)
from lshrs_tpu_torch.utils.trace import span

__all__ = [
    "cascade_coarse_keys",
    "cascade_coarse_scale",
    "cascade_slice_queries",
    "hamming_block_slots",
    "hamming_topk_blocked_core",
    "hamming_topk_cascade_core",
    "hamming_topk_chunked_core",
    "hamming_topk_core",
    "hamming_topk_packed_chunked_core",
    "hamming_topk_packed_core",
    "hamming_final_topk",
    "hamming_refine_gather",
    "hamming_refine_topk",
    "hamming_refine_topk_ref",
    "hamming_select_terms",
    "int8_dots",
    "merge_hamming_pools",
    "plane_width",
    "popcount32",
    "refine_hamming",
    "refine_kernel_fits",
    "refine_query_words",
    "supports_hamming_grouped",
    "unpack_bitplanes",
]


def supports_hamming_grouped(num_perm: int, capacity: int) -> bool:
    """True when the (scaled-dot, tie) key packs into a positive int32."""
    return (num_perm + 2) * key_scale(capacity) < 2**31


def hamming_block_slots(num_perm: int) -> int:
    """The most slots one B2 or B3 launch can key in int32: the largest
    power of two ``B`` with ``(num_perm + 2) * B < 2**31`` (2**22 at 256
    bits). A store ranks by Hamming distance in blocks of at most ``B``
    slots (:func:`hamming_topk_blocked_core`)."""
    return 1 << (((2**31 - 1) // (num_perm + 2)).bit_length() - 1)


def cascade_coarse_scale(p_pre: int, capacity: int) -> tuple[int, int]:
    """``(scale, tie_shift)`` of the cascade's coarse group-max key.

    The coarse key ``scaled * scale + (tie >> tie_shift)`` must pack into
    a positive int32 with ``scaled`` in ``[0, p_pre + 1]``. Below the
    ceiling the shift is 0 (the exact-selection format); past it the tie
    term is right-shifted, which only merges ties within ``2**tie_shift``
    id ranks when the coarse pass picks groups: the refine re-ranks with
    the true tie.
    """
    scale = key_scale(capacity)
    tie_shift = 0
    while (p_pre + 2) * (scale >> tie_shift) >= 2**31:
        tie_shift += 1
    return scale >> tie_shift, tie_shift


def plane_width(num_perm: int) -> int:
    """Columns of the stored bitplanes: ``num_perm`` rounded up to a
    multiple of 32, so every row stride suits the B2 kernel's TMA loads
    and its 32-byte wgmma k-steps."""
    return -(-num_perm // 32) * 32


def unpack_bitplanes(
    words: torch.Tensor, *, num_bands: int, rows_per_band: int, width: int | None = None
) -> torch.Tensor:
    """Packed int32 signature words -> +-1 int8 bitplanes.

    Args:
        words: ``(n, num_bands * W)`` int32 (see `lshrs_tpu_torch.ops.bitpack`).
        width: columns of the result (default ``num_bands * rows_per_band``);
            the columns past the signature are zero.
    Returns:
        ``(n, width)`` int8, {-1, +1} over the signature's bits in the
        packing's order (band-major, row-minor).
    """
    n = words.shape[0]
    w = words.shape[1] // num_bands
    p = num_bands * rows_per_band
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    # (word >> s) & 1 is bit s even under the arithmetic shift of int32.
    bits = (words.reshape(n, num_bands, w, 1) >> shifts) & 1
    bits = bits.reshape(n, num_bands, w * 32)[:, :, :rows_per_band]
    planes = (2 * bits - 1).to(torch.int8).reshape(n, p)
    if width is None or width == p:
        return planes
    return torch.nn.functional.pad(planes, (0, width - p))


def hamming_topk_core(
    planes: torch.Tensor,
    tie: torch.Tensor,
    qbits: torch.Tensor,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    k: int,
    group: int,
    narrow_r: int = 0,
    num_perm: int | None = None,
    sig_t: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
    live: int | None = None,
    refine_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc), grouped bitplane path.

    Args:
        planes: ``(C, Pp)`` int8 store bitplanes (dead slots arbitrary),
            zero past the signature's ``num_perm`` columns.
        tie: ``(C,)`` int32 global tie keys (-1 dead).
        qbits / qwords: ``(Q, Pp)`` int8 (padded like ``planes``) and
            ``(Q, BW)`` int32 queries.
        sig_rows: ``(C // group, group * (nw + 2))`` grouped refine table
            (`lshrs_tpu_torch.ops.scan.build_grouped_refine_rows`);
            narrow-packed when ``narrow_r`` is nonzero. ``None`` refines
            slot by slot from ``sig_t``, ``tie`` and ``ids`` (filtered
            queries: the table bakes in the unfiltered columns).
        num_perm: signature bits P (default ``Pp``).
        sig_t / ids: ``(BW, C)`` packed words and ``(C,)`` id column,
            needed only without ``sig_rows``.
        live: score only the first ``live`` slots (a multiple of ``group``,
            at most C; ``None``: all C), when every slot past them is dead.
            The keys keep C's scale, so each scored slot's key is the
            full launch's, and the groups left out could only have keyed
            at or below 0, under every alive key: the answer is the full
            launch's.
        refine_capacity: the C of the store whose ties ``sig_rows`` holds,
            when ``planes`` is one block of it
            (:func:`hamming_topk_blocked_core`): the refine keys the
            table's global ties at that C's scale, in int64 past the int32
            ceiling. ``None``: the ties are ``tie``'s.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry
        id -1 and hamming P+1.
    """
    c, p = planes.shape
    p = p if num_perm is None else num_perm
    n = _live_prefix(c, live, group)
    gmax = hamming_group_max_keys(
        planes[:n], tie[:n], qbits, group=group, scale=key_scale(c), num_perm=p
    )
    return _select_refine(
        gmax, qwords, sig_rows, p=p, k=k, group=group, narrow_r=narrow_r,
        sig_t=sig_t, tie=tie, ids=ids, capacity=refine_capacity or c,
        wide_ok=refine_capacity is not None,
    )


def hamming_topk_packed_core(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    num_perm: int,
    k: int,
    group: int,
    narrow_r: int = 0,
    ids: torch.Tensor | None = None,
    word_bits: int = 32,
    live: int | None = None,
    refine_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc) from the PACKED words only: the
    one-block case of :func:`hamming_topk_blocked_core` on packed words, as
    :func:`hamming_topk_core` is on bitplanes.

    No bitplane array: kernel B3 scores the slots from the same ``(BW, C)``
    store the collision scan uses, read in place. Results equal
    :func:`hamming_topk_core`'s bit for bit.

    Args:
        sig_t: ``(BW, C)`` int32 transposed signatures (dead slots
            arbitrary), or the view ``words[:, s:e]`` of one block of a
            wider store's words.
        tie: ``(C,)`` int32 tie keys (-1 dead).
        qwords: ``(Q, BW)`` int32 query words.
        sig_rows: grouped refine table, as for :func:`hamming_topk_core`
            (``None``: per-slot refinement, which needs ``ids``).
        word_bits: the low bits of each word that hold signature bits
            (kernel B3 multiplies ``BW * word_bits`` columns); higher bits
            must be zero on both sides.
        live / refine_capacity: as for :func:`hamming_topk_core`: B3 scores
            the view ``sig_t[:, :live]`` at C's key scale.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry
        id -1 and hamming P+1.
    """
    c = sig_t.shape[1]
    n = _live_prefix(c, live, group)
    gmax = hamming_packed_group_max_keys(
        sig_t[:, :n], tie[:n], qwords, num_perm=num_perm, group=group,
        scale=key_scale(c), word_bits=word_bits,
    )
    return _select_refine(
        gmax, qwords, sig_rows, p=num_perm, k=k, group=group, narrow_r=narrow_r,
        sig_t=sig_t, tie=tie, ids=ids, capacity=refine_capacity or c,
        wide_ok=refine_capacity is not None,
    )


def _live_prefix(c: int, live: int | None, group: int) -> int:
    """The slots a single-pass core scores: ``live`` (C when ``None``), a
    positive multiple of ``group`` up to C."""
    n = c if live is None else live
    if n <= 0 or n > c or n % group:
        raise ValueError(f"live={live} must be a positive multiple of group={group} up to C={c}")
    return n


def hamming_select_terms(
    ng: int, group: int, *, p: int, k: int, m_groups: int | None = None,
    capacity: int | None = None, wide_ok: bool = False,
) -> tuple[int, int, bool]:
    """``(m, scale, wide)`` of the Hamming selection tail over ``ng``
    groups: the groups refined, the refine key's scale, and whether that
    key is int64 (``(p + 2) * key_scale(C)`` past int32: the cascade, and
    a block's refine of the global ties, ``wide_ok``; the other
    single-pass calls, ``m_groups=None``, refuse it). ``capacity``: the
    store's C when the groups cover only its first slots or one block
    (default ``ng * group``); the ties, and so the scale, are C's."""
    scale = key_scale(ng * group if capacity is None else capacity)
    wide = (p + 2) * scale >= 2**31
    if wide and m_groups is None and not wide_ok:
        raise NotImplementedError(
            "the single-pass Hamming engines' keys are int32: past the "
            "ceiling rank in blocks (hamming_topk_blocked_core)"
        )
    return min(k if m_groups is None else max(k, m_groups), ng), scale, wide


def hamming_refine_gather(
    qwords, sig_rows, top_groups, *, group, narrow_r=0, sig_t=None, tie=None, ids=None
):
    """The gather stage of the Hamming tail: ``(words (Q, m, nw, group),
    tie (Q, m, group), ids (Q, m, group), query words (Q, nw))`` of the
    selected groups, from the grouped refine table (narrow-packed when
    ``narrow_r`` is nonzero: the queries are packed alike) or, without
    ``sig_rows``, slot by slot from ``sig_t``, ``tie`` and ``ids``."""
    if sig_rows is None:
        if sig_t is None or ids is None:
            raise ValueError("sig_rows=None (per-slot refinement) needs sig_t and ids")
        return (*gather_refine_slots(sig_t, tie, ids, top_groups, group=group), qwords)
    qcmp = refine_query_words(qwords, narrow_r)
    return (*gather_refine_group_rows(sig_rows, top_groups, bw=qcmp.shape[1], group=group), qcmp)


def refine_query_words(qwords: torch.Tensor, narrow_r: int = 0) -> torch.Tensor:
    """The queries' ``(Q, nw)`` words in the grouped refine table's packing:
    narrow-packed when ``narrow_r`` is nonzero (one word a band, so BW is
    the band count), else ``qwords`` itself."""
    if not narrow_r:
        return qwords
    return pack_words_narrow(qwords, num_bands=qwords.shape[1], rows_per_band=narrow_r)


def refine_hamming(cwords: torch.Tensor, qcmp: torch.Tensor) -> torch.Tensor:
    """The popcount stage: ``(Q, m, group)`` int32 Hamming distances of the
    gathered words to the queries' (any packing: popcount is
    layout-agnostic)."""
    return popcount32(cwords ^ qcmp[:, None, :, None]).sum(2, dtype=torch.int32)


def hamming_final_topk(hamming, cand_tie, cand_ids, *, p, k, scale, wide):
    """Last stage of the Hamming tail: the ``(hamming asc, id asc)`` keys of
    the refined candidates (int64 when ``wide``) and their exact top-k,
    ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry id -1
    and hamming ``p + 1``."""
    q = hamming.shape[0]
    hamming = hamming.reshape(q, -1)
    mg = hamming.shape[1]
    cand_tie = cand_tie.reshape(q, mg)
    scaled = torch.where(cand_tie >= 0, p + 1 - hamming, 0)
    if wide:
        scaled = scaled.to(torch.int64)
    key = scaled * scale + cand_tie.clamp(min=0)
    k_eff = min(k, mg)
    top_key, top_pos = torch.topk(key, k_eff, dim=1)
    sel_scaled = (top_key // scale).to(torch.int32)
    picked = cand_ids.reshape(q, mg).gather(1, top_pos)
    sel_ids = torch.where(sel_scaled > 0, picked, -1)
    out_h = torch.where(sel_scaled > 0, p + 1 - sel_scaled, p + 1)
    if k_eff < k:
        out_h = torch.nn.functional.pad(out_h, (0, k - k_eff), value=p + 1)
        sel_ids = torch.nn.functional.pad(sel_ids, (0, k - k_eff), value=-1)
    return out_h, sel_ids


# The limits of kernel hamming_refine_topk: words a slot, slots a group,
# k, and candidates a query (m * group).
_REFINE_KERNEL_WORDS = 64
_REFINE_KERNEL_GROUPS = (16, 32, 64, 128)
_REFINE_KERNEL_K = 128
_REFINE_KERNEL_CANDIDATES = 8192


def refine_kernel_fits(*, nw: int, group: int, k: int, m: int) -> bool:
    """True when :func:`hamming_refine_topk` takes the tail of ``m`` groups
    of ``group`` slots of ``nw`` refine words at top-``k``."""
    return (
        0 < nw <= _REFINE_KERNEL_WORDS and group in _REFINE_KERNEL_GROUPS
        and 0 < k <= _REFINE_KERNEL_K and 0 < m * group <= _REFINE_KERNEL_CANDIDATES
    )


def hamming_refine_topk_ref(qwords, sig_rows, top_groups, *, group, p, k, scale, narrow_r=0):
    """Plain PyTorch version of kernel ``hamming_refine_topk`` (see
    :func:`hamming_refine_topk`): the query words' packing
    (:func:`refine_query_words`) and the three stages of the tail,
    :func:`gather_refine_group_rows`, :func:`refine_hamming` and
    :func:`hamming_final_topk`, its key in int64 where int32 cannot hold
    it. Spans ``lshrs.refine`` (the packing, the gather and the popcount),
    then ``lshrs.topk``."""
    with span("lshrs.refine"):
        qcmp = refine_query_words(qwords, narrow_r)
        cwords, cand_tie, cand_ids = gather_refine_group_rows(
            sig_rows, top_groups, bw=qcmp.shape[1], group=group
        )
        hamming = refine_hamming(cwords, qcmp)
    with span("lshrs.topk"):
        return hamming_final_topk(
            hamming, cand_tie, cand_ids, p=p, k=k, scale=scale, wide=(p + 2) * scale >= 2**31,
        )


def hamming_refine_topk(
    qwords: torch.Tensor,
    sig_rows: torch.Tensor,
    top_groups: torch.Tensor,
    *,
    group: int,
    p: int,
    k: int,
    scale: int,
    narrow_r: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Hamming tail after the group selection in one launch — kernel
    ``hamming_refine_topk`` (CUDA source ``csrc/hamming_refine_topk.cu``):
    gather the selected groups' rows, XOR-popcount them against the
    queries, and take the exact ``(hamming asc, id asc)`` top-k of the
    candidates, keyed in 64 bits.

    Args:
        qwords: ``(Q, BW)`` int32 query words, packed as the table is
            (``narrow_r``) into ``nw`` words, at most 64.
        sig_rows: ``(C // group, (nw + 2) * group)`` int32 grouped refine
            table (`lshrs_tpu_torch.ops.scan.build_grouped_refine_rows`):
            word-major rows, then the tie column (-1 dead; alive ties
            distinct and below ``scale``), then the id column.
        top_groups: ``(Q, m)`` int64 distinct group indices a query
            (`lshrs_tpu_torch.ops.scan.select_top_groups`), ``m * group``
            at most 8,192.
        group: slots per group, 16, 32, 64 or 128.
        p: signature bits P (at most 4,094).
        k: answers a query, 1..128.
        scale: the ties' ``key_scale(C)``, a power of two.
        narrow_r: nonzero when the table is narrow-packed at that many
            rows a band (:func:`refine_query_words`).

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry id
        -1 and hamming ``p + 1`` (:func:`hamming_final_topk`'s, bit for
        bit). CPU tensors take the plain version
        (:func:`hamming_refine_topk_ref`, its spans ``lshrs.refine`` and
        ``lshrs.topk``); CUDA tensors pack the query words and launch the
        kernel in span ``lshrs.refine``, counted in ``launches`` and by
        ``(nw, group)`` in ``launches_by_shape``.
    """
    q, bw = qwords.shape
    m = top_groups.shape[1]
    nw = narrow_words_count(bw, narrow_r) if narrow_r else bw
    _check("qwords", qwords, torch.int32, (q, bw))
    _check("sig_rows", sig_rows, torch.int32, (sig_rows.shape[0], (nw + 2) * group))
    _check("top_groups", top_groups, torch.int64, (q, m))
    if not refine_kernel_fits(nw=nw, group=group, k=k, m=m):
        raise ValueError(
            f"the refine kernel takes nw <= {_REFINE_KERNEL_WORDS}, group in "
            f"{_REFINE_KERNEL_GROUPS}, k <= {_REFINE_KERNEL_K} and m * group <= "
            f"{_REFINE_KERNEL_CANDIDATES}; got nw={nw}, group={group}, k={k}, m={m}"
        )
    if not 0 < p <= 4094 or scale <= 1 or scale & (scale - 1):
        raise ValueError(f"p must be in 1..4094 and scale a power of two; got p={p}, scale={scale}")
    dev = _device(qwords, sig_rows, top_groups)
    if dev.type == "cpu":
        return hamming_refine_topk_ref(qwords, sig_rows, top_groups, group=group, p=p, k=k,
                                       scale=scale, narrow_r=narrow_r)
    if not (sig_rows.is_contiguous() and top_groups.is_contiguous()):
        raise ValueError("hamming_refine_topk: CUDA sig_rows and top_groups must be contiguous")
    if sig_rows.data_ptr() % 16:
        raise ValueError("hamming_refine_topk: sig_rows must be 16-byte aligned")
    out_h = torch.empty((q, k), dtype=torch.int32, device=dev)
    out_ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_h, out_ids
    with span("lshrs.refine"):
        qcmp = refine_query_words(qwords, narrow_r).contiguous()
        _launch(
            "lshrs_hamming_refine_topk", dev,
            sig_rows.data_ptr(), top_groups.data_ptr(), qcmp.data_ptr(), out_h.data_ptr(),
            out_ids.data_ptr(), q, m, nw, group, k, p, scale.bit_length() - 1,
        )
    hamming_refine_topk.launches += 1
    hamming_refine_topk.launches_by_shape[nw, group] += 1
    return out_h, out_ids


hamming_refine_topk.launches = 0
# The same launches, by (refine words nw, group).
hamming_refine_topk.launches_by_shape = collections.Counter()


def _select_refine(
    gmax, qwords, sig_rows, *, p, k, group, narrow_r=0, sig_t=None, tie=None, ids=None,
    m_groups=None, capacity=None, wide_ok=False,
):
    """Hamming selection tail: top-k groups by max, popcount-exact refine
    from the gathered packed words, exact (hamming, id) order. Its stages:
    :func:`select_top_groups`, then, on a grouped refine table, kernel
    :func:`hamming_refine_topk` within :func:`refine_kernel_fits` (span
    ``lshrs.refine`` alone on the card) and its plain version past them;
    without the table :func:`hamming_refine_gather` and
    :func:`refine_hamming` (span ``lshrs.refine``), then
    :func:`hamming_final_topk` (span ``lshrs.topk``): the same answer.

    ``narrow_r`` nonzero means ``sig_rows`` is narrow-packed. Popcount is
    layout-agnostic — the narrow words hold exactly the same set bits — so
    only the word count and the query packing change. Without
    ``sig_rows`` the candidates' words, ties and ids are gathered slot by
    slot from ``sig_t``, ``tie`` and ``ids`` (word-aligned).

    ``m_groups``: refine the top ``max(k, m_groups)`` groups (the
    cascade's deep pool, whose coarse keys rank a prefix of the bits).
    There the refine key is int64 once ``(p + 2) * key_scale(C)`` passes
    int32 — the same ``(hamming asc, id asc)`` order. The single-pass
    engines (``m_groups=None``) refuse that regime: their kernels' keys
    are int32.

    ``capacity``: the store's C when ``gmax`` covers only its first
    slots (:func:`hamming_topk_core`'s ``live``) or one block of it
    (``refine_capacity``, with ``wide_ok``).
    """
    m, scale, wide = hamming_select_terms(
        gmax.shape[1], group, p=p, k=k, m_groups=m_groups, capacity=capacity, wide_ok=wide_ok
    )
    top_groups = select_top_groups(gmax, m)
    if sig_rows is None:
        with span("lshrs.refine"):
            cwords, cand_tie, cand_ids, qcmp = hamming_refine_gather(
                qwords, None, top_groups, group=group, sig_t=sig_t, tie=tie, ids=ids,
            )
            hamming = refine_hamming(cwords, qcmp)
        with span("lshrs.topk"):
            return hamming_final_topk(hamming, cand_tie, cand_ids, p=p, k=k, scale=scale, wide=wide)
    fused = refine_kernel_fits(nw=sig_rows.shape[1] // group - 2, group=group, k=k, m=m)
    tail = hamming_refine_topk if fused else hamming_refine_topk_ref
    return tail(qwords, sig_rows, top_groups, group=group, p=p, k=k, scale=scale,
                narrow_r=narrow_r)


def merge_hamming_pools(
    hamming: torch.Tensor, ids: torch.Tensor, *, p: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact ``(hamming asc, id asc)`` top-k of pooled ``(Q, n)``
    Hamming lists (a blocked store's blocks, a sharded store's shards),
    ``(hamming (Q, k), ids (Q, k))`` int32; empty entries (id -1) carry
    hamming ``p + 1``. Span ``lshrs.merge``."""
    with span("lshrs.merge"):
        # merge_topk_pools ranks positive keys: similarity P + 1 - distance.
        sim, m_ids = merge_topk_pools(torch.where(ids >= 0, p + 1 - hamming, 0), ids, k=k)
        return torch.where(m_ids >= 0, p + 1 - sim, p + 1), m_ids


def hamming_topk_blocked_core(
    planes: torch.Tensor | None,
    block_tie: torch.Tensor,
    qbits: torch.Tensor | None,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    k: int,
    group: int,
    block: int,
    live: int,
    narrow_r: int = 0,
    num_perm: int | None = None,
    sig_t: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
    word_bits: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc), in one block or many, on
    bitplanes or on the packed words: each block of ``block`` slots goes
    through :func:`hamming_topk_core` (kernel B2 on ``planes[s:e]``) or,
    with ``planes=None``, :func:`hamming_topk_packed_core` (kernel B3 on
    the words ``sig_t[:, s:e]``, read in place), then, past one block, one
    merge (:func:`merge_hamming_pools`).

    Each block's key is ``scaled * key_scale(block) + block tie``, which
    packs into int32 when ``block`` is at most :func:`hamming_block_slots`;
    the block's answer is its exact top-k, and with one block (``block ==
    C``) the answer. Ties of distance between blocks go to the smaller id
    in the merge, as the global order has it; an id stored twice
    (``dedupe=False``) keeps slot order, the blocks entering the merge's
    stable sorts in slot order.

    Args:
        planes: ``(C, Pp)`` int8 store bitplanes, C a multiple of ``block``;
            ``None`` ranks on the packed words ``sig_t`` (``num_perm`` is
            then required).
        block_tie: ``(C,)`` int32 block-local tie keys,
            ``key_scale(block) - 1 - rank`` of each slot's id among its
            block's slots, -1 dead (filtered-out slots too): with one
            block, the global ties.
        qbits / qwords: as for :func:`hamming_topk_core` (``qbits`` unused
            on packed words).
        sig_rows: the store's grouped refine table, with its global ties
            (each block refines them at C's scale, int64 past the
            ceiling); ``None`` refines slot by slot from ``sig_t``,
            ``block_tie`` and ``ids`` (filtered queries).
        block: slots per block, a power of two and a multiple of ``group``.
        live: score the first ``live`` slots (a positive multiple of
            ``group``; every slot past them dead). Blocks past it are not
            launched; the last one launched scores its live part.
        sig_t: ``(BW, C)`` int32 packed words: what ``planes=None`` ranks,
            and what the slot-by-slot refine gathers.
        word_bits: the low bits of each word that B3 expands (packed words
            only; see :func:`hamming_topk_packed_core`).

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry
        id -1 and hamming P+1.
    """
    packed = planes is None
    if packed and (sig_t is None or num_perm is None):
        raise ValueError("ranking the packed words (planes=None) needs sig_t and num_perm")
    c = sig_t.shape[1] if packed else planes.shape[0]
    p = planes.shape[1] if num_perm is None else num_perm
    if block % group or c % block or not 0 < live <= c or live % group:
        raise ValueError(
            f"block={block} must be a multiple of group={group} dividing C={c}, and "
            f"live={live} a positive multiple of the group up to C"
        )
    if not supports_hamming_grouped(p, block):
        raise ValueError(f"a block of {block} slots keys past int32 at P={p}")
    parts = []
    for s in range(0, live, block):
        e = s + block
        words = None if sig_t is None else sig_t[:, s:e]
        kw = dict(
            k=k, group=group, narrow_r=narrow_r, ids=None if ids is None else ids[s:e],
            live=min(live, e) - s, refine_capacity=None if sig_rows is None else c,
        )
        rows = None if sig_rows is None else sig_rows[s // group : e // group]
        if packed:
            parts.append(hamming_topk_packed_core(
                words, block_tie[s:e], qwords, rows, num_perm=p, word_bits=word_bits, **kw
            ))
        else:
            parts.append(hamming_topk_core(
                planes[s:e], block_tie[s:e], qbits, qwords, rows, num_perm=p, sig_t=words, **kw
            ))
    if len(parts) == 1:
        return parts[0]
    return merge_hamming_pools(
        torch.cat([h for h, _ in parts], dim=1), torch.cat([i for _, i in parts], dim=1),
        p=p, k=k,
    )


# A cascade batch goes through in query slices that keep the coarse
# pass's (Q, C / group) int32 keys plus the refine's int64 (Q, pool, words)
# popcount temporaries near this many bytes.
_CASCADE_SLICE_BYTES = 1 << 31


def cascade_slice_queries(capacity: int, *, group: int, pool_groups: int, words: int) -> int:
    """Queries per slice of a cascade batch (2,048 at 2**23 slots, group
    64 and a 128-group pool of 8-word rows). ``pool_groups`` is the
    refined groups per query, ``words`` the refine's words per slot. No
    128-query floor: it would overshoot the bound."""
    per_query = 4 * (capacity // group) + 8 * pool_groups * group * words
    return max(1, _CASCADE_SLICE_BYTES // per_query)


def cascade_coarse_keys(
    planes_prefix: torch.Tensor, tie: torch.Tensor, qbits_prefix: torch.Tensor, *, group: int
) -> torch.Tensor:
    """The cascade's coarse pass: kernel B2 over the prefix planes with the
    coarse key of :func:`cascade_coarse_scale` (the tie shifted past the
    ceiling), ``(Q, C / group)`` int32 group maxes."""
    c, p_pre = planes_prefix.shape
    scale, tie_shift = cascade_coarse_scale(p_pre, c)
    tie_coarse = torch.where(tie >= 0, tie >> tie_shift, tie) if tie_shift else tie
    return hamming_group_max_keys(planes_prefix, tie_coarse, qbits_prefix, group=group, scale=scale)


def hamming_topk_cascade_core(
    planes_prefix: torch.Tensor,
    tie: torch.Tensor,
    qbits_prefix: torch.Tensor,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    num_perm: int,
    k: int,
    refine_groups: int,
    group: int,
    narrow_r: int = 0,
    sig_t: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass refinement-cascade Hamming top-k.

    Pass 1 runs kernel B2 over the first ``cb = planes_prefix.shape[1]``
    bitplane columns (``cb / num_perm`` of the full product) with the
    coarse key of :func:`cascade_coarse_scale`; the top ``max(k,
    refine_groups)`` groups by max form the pool, selected exactly (the
    integer keys are distinct among groups holding an alive slot). Pass 2
    re-ranks every slot of the pool by the full ``num_perm``-bit popcount
    of the packed words (:func:`_select_refine`).

    Contract: the exact ``(hamming asc, id asc)`` top-k WITHIN the pool
    (``refine_groups * group`` slots) — the full-width ranking whenever
    the pool covers the store; otherwise the prefix can exclude a true
    top-k slot.

    It runs the whole batch at once: callers slice large batches by
    :func:`cascade_slice_queries`.

    Args:
        planes_prefix: ``(C, cb)`` int8 ±1 prefix planes, ``cb`` a multiple
            of 32 below ``num_perm``.
        tie: ``(C,)`` int32 global tie keys (-1 dead).
        qbits_prefix: ``(Q, cb)`` int8 query prefix bits (contiguous).
        qwords: ``(Q, BW)`` int32 query words (the refine's operand).
        sig_rows / narrow_r / sig_t / ids: the refine's table, as for
            :func:`hamming_topk_core`.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry
        id -1 and hamming ``num_perm + 1``.
    """
    gmax = cascade_coarse_keys(planes_prefix, tie, qbits_prefix, group=group)
    return _select_refine(
        gmax, qwords, sig_rows, p=num_perm, k=k, group=group, narrow_r=narrow_r,
        sig_t=sig_t, tie=tie, ids=ids, m_groups=refine_groups,
    )


def int8_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b.T`` of int8 ``(m, K)`` and ``(n, K)`` operands, ``(m, n)``
    int32, by ``torch._int_mm``. Its CUDA route needs more than 16 rows and
    ``K``, ``n`` multiples of 8: ``a``'s rows are zero-padded to a multiple
    of 8 past 16 and ``b``'s rows to a multiple of 8 (zero rows and
    columns add nothing); ``b.T`` is the column-major operand it takes."""
    m, kdim = a.shape
    n = b.shape[0]
    if kdim % 8:
        raise ValueError(f"K={kdim} must be a multiple of 8")
    mp = max(24, -(-m // 8) * 8)
    np_ = -(-n // 8) * 8
    if mp != m:
        a = torch.nn.functional.pad(a, (0, 0, 0, mp - m))
    if np_ != n:
        b = torch.nn.functional.pad(b, (0, 0, 0, np_ - n))
    out = torch._int_mm(a, b.T)
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _hamming_chunked(dots_of, ids, ranks, *, q, k, chunk, step, offset, p):
    """Shared tail of the Hamming chunked cores: ``dots_of(s, e)`` gives the
    ``(Q, e - s)`` int32 dots with ``dots + offset = 2 * (P + 1 - hamming)``
    at every alive slot. The key ranks that doubled similarity, ``(dots +
    offset) * chunk + (chunk - 1 - rank)``: one fused multiply-add per
    step, the same order as the reference's halved key."""
    mult, bias = chunk_key_terms(ids, ranks, mult=chunk, bias=offset * chunk, chunk=chunk)

    def keys(s, e):
        return torch.addcmul(bias[None, s:e], dots_of(s, e), mult[None, s:e])

    scaled2, out_ids = chunked_topk_scan(keys, ids, q=q, k=k, chunk=chunk, step=step)
    return torch.where(out_ids >= 0, p + 1 - scaled2 // 2, p + 1), out_ids


def hamming_topk_chunked_core(
    planes: torch.Tensor,
    ids: torch.Tensor,
    ranks: torch.Tensor,
    qbits: torch.Tensor,
    *,
    k: int,
    chunk: int,
    num_perm: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc) on bitplanes, chunked selection
    (the fallback where the grouped key does not pack into int32, or the
    capacity is below the group).

    Args:
        planes: ``(C, Pp)`` int8 +-1 store bitplanes, zero past ``num_perm``
            columns (``Pp`` a multiple of 8); C a multiple of ``chunk``.
        ids: ``(C,)`` int32 slot ids, -1 dead.
        ranks: ``(C,)`` int32 id rank within each chunk
            (`lshrs_tpu_torch.ops.scan.compute_chunk_ranks`).
        qbits: ``(Q, Pp)`` int8 query bits, padded like ``planes``.
        num_perm: signature bits P (default ``Pp``): the padding columns
            add nothing to the dot, but the distance is ``P``'s.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry id
        -1 and hamming P+1.
    """
    p = planes.shape[1] if num_perm is None else num_perm
    q = qbits.shape[0]
    # dots = P - 2 * hamming.
    return _hamming_chunked(
        lambda s, e: int8_dots(qbits, planes[s:e]), ids, ranks,
        q=q, k=k, chunk=chunk, step=chunk_step(q, chunk), offset=p + 2, p=p,
    )


def hamming_topk_packed_chunked_core(
    sig_t: torch.Tensor,
    ids: torch.Tensor,
    ranks: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_perm: int,
    k: int,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (hamming asc, id asc) from PACKED words, chunked
    selection; results equal :func:`hamming_topk_chunked_core`'s.

    Each step unpacks its slots' words to +-1 int8 over all ``32 * BW``
    bits and takes one int8 product with the query's bits, ``dot = 32 * BW
    - 2 * hamming`` (bits past a band's rows are zero in both words), so
    the store keeps no bitplanes.

    Args:
        sig_t: ``(BW, C)`` int32 transposed signatures; C a multiple of
            ``chunk``.
        ids / ranks: as for :func:`hamming_topk_chunked_core`.
        qwords: ``(Q, BW)`` int32 query words.

    Returns:
        ``(hamming (Q, k), ids (Q, k))`` int32; empty tail entries carry id
        -1 and hamming ``num_perm + 1``.
    """
    bw = sig_t.shape[0]
    q = qwords.shape[0]
    # Each word unpacked as a band of 32 rows: dots = 32 * BW - 2 * hamming.
    qbits = unpack_bitplanes(qwords, num_bands=bw, rows_per_band=32)
    return _hamming_chunked(
        lambda s, e: int8_dots(
            qbits, unpack_bitplanes(sig_t[:, s:e].T, num_bands=bw, rows_per_band=32)
        ),
        ids, ranks,
        q=q, k=k, chunk=chunk, step=chunk_step(q, chunk, slot_bytes=8 * 32 * bw),
        offset=2 * (num_perm + 1) - 32 * bw, p=num_perm,
    )
