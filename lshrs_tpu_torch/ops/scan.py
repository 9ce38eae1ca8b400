"""Collision-count top-k: group-max selection plus exact refinement.

The store keeps its signatures transposed, ``sig_t: (num_bands * W, C)``,
so the slot axis is minor for the scan. Exact ordering contract: the
reference sorts candidates by ``(-collision_count, id)``. Selection keys
embed each slot's *id-rank*, ``key = count * S + (S - 1 - rank)``, so all
alive keys are globally distinct and plain top-k selection is exact:

1. Kernel B1 (`lshrs_tpu_torch.ops.group_max.group_max_keys`) fuses count
   + key + contiguous group max into ``(Q, C / group)``.
2. Top-``k`` groups by max. Alive keys are distinct, so these groups
   provably hold every true top-k slot; ties exist only among groups with
   no alive slot of count > 0, whose slots can only yield id -1, so one
   flat selection (kernel :func:`group_select` on the card, ``torch.topk``
   on the CPU) returns exactly what the reference's blockwise selector
   does.
3. One gather of each selected group's wide row from the grouped refine
   table, a recount of its slots against the query, and an exact top-k
   over the ``k * group`` candidates. Under a ``where=`` filter the table
   (which bakes in the unfiltered tie and id columns) is not used: the
   selected groups' slots are gathered one by one from ``sig_t`` and the
   filtered columns (:func:`gather_refine_slots`).

The full-count paths of the top-p slice live here too:
:func:`collision_counts_core` (every slot's count, for the full rerank
engine) and :func:`collision_nnz_core` (each query's number of colliding
candidates, without the ``(Q, C)`` matrix), both plain PyTorch stepped
over the slot axis.

The chunked fallback (:func:`collision_topk_core`) serves the stores the
grouped key cannot: more than 64 bands, a key past int32
(``(num_bands + 1) * key_scale(C) >= 2**31``) or a capacity below the
group. Its keys embed each slot's rank WITHIN its ``chunk``-slot chunk
(:func:`compute_chunk_ranks`), ``key = count * chunk + (chunk - 1 -
rank)``, which packs into int32 at any capacity; each chunk's top
``min(k, chunk)`` goes to a running exact merge by ``(count desc, id
asc)`` (:func:`merge_topk_pools`). :func:`chunked_topk_scan` is the
selection shared with the Hamming and asymmetric chunked cores: it steps
over the slot axis at :func:`chunk_step` slots, one ``torch.topk`` over
the ``(Q, chunks, chunk)`` keys per step, so the ``(Q, C)`` matrix never
exists.
"""

from __future__ import annotations

import torch

from lshrs_tpu_torch.ops.bitpack import narrow_words_count, pack_words_narrow
from lshrs_tpu_torch.ops.group_max import (
    _device,
    _launch,
    band_counts_t,
    group_max_keys,
    key_scale,
    supports_fast_path,
)
from lshrs_tpu_torch.utils.trace import span

__all__ = [
    "band_counts_t",
    "build_grouped_refine_rows",
    "chunk_key_terms",
    "chunk_step",
    "chunked_topk_scan",
    "collision_counts_core",
    "collision_final_topk",
    "collision_nnz_core",
    "collision_topk_core",
    "collision_topk_grouped_core",
    "compute_chunk_ranks",
    "count_step",
    "gather_refine",
    "gather_refine_group_rows",
    "gather_refine_slots",
    "global_tie_core",
    "group_select",
    "key_scale",
    "merge_topk_pools",
    "refine_counts_vs_query",
    "select_kernel_fits",
    "select_top_groups",
    "supports_fast_path",
]

_INT32_MAX = 2**31 - 1

# (query, slot) pairs per step of the full-count scans: ~1 GB of int32
# counts per step (one step at Q=256, C=2**20), where the reference's
# 2,048-slot scan steps would mean 512 launches per call at 1M slots.
_COUNT_STEP_PAIRS = 1 << 28


def count_step(q: int, floor: int) -> int:
    """Slots per step of :func:`collision_counts_core` /
    :func:`collision_nnz_core` for a ``q``-query batch (at least ``floor``)."""
    return max(floor, _COUNT_STEP_PAIRS // max(1, q))


def chunk_step(q: int, chunk: int, *, slot_bytes: int = 0) -> int:
    """Slots per step of the chunked cores for a ``q``-query batch: about
    :func:`count_step`'s ``(Q, slots)`` int32 keys, and at most ~1 GiB of
    ``slot_bytes``-byte per-slot temporaries (the packed core's unpacked
    bits), in whole chunks."""
    step = count_step(q, chunk)
    if slot_bytes:
        step = min(step, (1 << 30) // slot_bytes)
    return max(chunk, step // chunk * chunk)


def merge_topk_pools(
    pool_counts: torch.Tensor, pool_ids: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge pooled (count, id) candidates to the exact global top-k.

    Ascending lexicographic order by (-count, id); empty entries (count 0)
    go to the end via id = INT32_MAX. Two stable sorts (minor key first)
    give the lexicographic order.
    """
    tie_ids = torch.where(pool_counts > 0, pool_ids, _INT32_MAX)
    order = torch.argsort(tie_ids, dim=1, stable=True)
    order = order.gather(1, torch.argsort(-pool_counts.gather(1, order), dim=1, stable=True))
    out_k = min(k, pool_counts.shape[1])
    counts_out = pool_counts.gather(1, order[:, :out_k])
    ids_out = torch.where(counts_out > 0, pool_ids.gather(1, order[:, :out_k]), -1)
    if out_k < k:  # pool smaller than k: pad
        counts_out = torch.nn.functional.pad(counts_out, (0, k - out_k))
        ids_out = torch.nn.functional.pad(ids_out, (0, k - out_k), value=-1)
    return counts_out, ids_out


def chunked_topk_scan(keys, ids, *, q: int, k: int, chunk: int, step: int):
    """Exact top-k of chunk-ranked selection keys, ``(scaled (Q, k), ids
    (Q, k))`` int32, ordered by ``(scaled desc, id asc)``.

    ``keys(s, e)`` returns the ``(Q, e - s)`` int32 keys ``scaled * chunk +
    (chunk - 1 - rank)`` of slots ``[s, e)``, ``scaled`` 0 at a dead slot
    and ``rank`` the slot's id rank within its chunk: within a chunk the
    keys are distinct, so ``torch.topk``'s order among equal values never
    matters. ``ids``: ``(C,)`` int32, ``C`` a multiple of ``chunk``;
    ``step`` a multiple of ``chunk``. Each step's per-chunk top
    ``min(k, chunk)`` folds into a running top-k through
    :func:`merge_topk_pools`, whose ``(-scaled, id)`` order is total, so
    the running merge equals one merge of every chunk's pool; empty
    entries (scaled 0) carry id -1.
    """
    c = ids.shape[0]
    kc = min(k, chunk)
    best = None
    for s in range(0, c, step):
        e = min(c, s + step)
        nc = (e - s) // chunk
        top_key, top_pos = keys(s, e).view(q, nc, chunk).topk(kc, dim=-1)
        pool_ids = ids[s:e].view(1, nc, chunk).expand(q, nc, chunk).gather(2, top_pos)
        pool_scaled = (top_key // chunk).reshape(q, nc * kc)
        pool_ids = pool_ids.reshape(q, nc * kc)
        if best is not None:
            pool_scaled = torch.cat([best[0], pool_scaled], dim=1)
            pool_ids = torch.cat([best[1], pool_ids], dim=1)
        best = merge_topk_pools(pool_scaled, pool_ids, k=k)
    return best


def chunk_key_terms(ids: torch.Tensor, ranks: torch.Tensor, *, mult: int, bias: int, chunk: int):
    """Per-slot ``(m, b)`` of the affine chunked key ``value * m + b``:
    ``m = mult``, ``b = bias + chunk - 1 - rank`` at alive slots, and ``m =
    0``, ``b = chunk - 1 - rank`` at dead ones (scaled 0)."""
    alive = ids >= 0
    rev = chunk - 1 - ranks
    return (
        torch.where(alive, mult, 0).to(torch.int32),
        torch.where(alive, rev + bias, rev).to(torch.int32),
    )


def collision_topk_core(
    sig_t: torch.Tensor,
    ids: torch.Tensor,
    ranks: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    k: int,
    chunk: int,
    probes: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (count desc, id asc), chunked selection (the
    fallback where the grouped key cannot run: more than 64 bands, a key
    past int32, a capacity below the group).

    Args:
        sig_t: ``(BW, C)`` int32 transposed signatures, C a multiple of
            ``chunk``.
        ids: ``(C,)`` int32 slot ids, -1 for dead / empty slots.
        ranks: ``(C,)`` int32 rank of each slot's id within its chunk
            (:func:`compute_chunk_ranks`).
        qwords: ``(Q, probes * BW)`` int32, probe-major (see
            :func:`band_counts_t`, which loops over any number of bands).

    Returns:
        ``(counts, ids)``, each ``(Q, k)`` int32; zero-count tail entries
        carry id -1.
    """
    q = qwords.shape[0]
    mult, bias = chunk_key_terms(ids, ranks, mult=chunk, bias=0, chunk=chunk)

    def keys(s: int, e: int) -> torch.Tensor:
        counts = band_counts_t(sig_t[:, s:e], qwords, num_bands, probes)
        return torch.addcmul(bias[None, s:e], counts, mult[None, s:e])

    return chunked_topk_scan(keys, ids, q=q, k=k, chunk=chunk, step=chunk_step(q, chunk))


def build_grouped_refine_rows(sig_rows_ext: torch.Tensor, *, group: int) -> torch.Tensor:
    """Per-slot refine table -> GROUP-ROW refine table.

    Args:
        sig_rows_ext: ``(C, nc)`` int32, ``nc = nw + 2`` (words | tie | id).
        group: slots per group (contiguous grouping, as the kernels use).

    Returns:
        ``(C // group, nc * group)`` int32; row ``g`` holds group ``g``'s
        slot rows WORD-MAJOR: ``nc`` blocks of ``group`` values (word 0 of
        every slot, then word 1, ..., then tie, then id), so the refine
        stage reads each word column of a gathered row contiguously.
    """
    c, nc = sig_rows_ext.shape
    r3 = sig_rows_ext.reshape(c // group, group, nc)
    return r3.transpose(1, 2).reshape(c // group, nc * group)


def gather_refine_group_rows(
    rows_g: torch.Tensor, top_groups: torch.Tensor, *, bw: int, group: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather whole candidate-group rows -> ``(words, tie, ids)``.

    Args:
        rows_g: ``(C // group, (bw + 2) * group)`` int32 grouped refine
            table (see :func:`build_grouped_refine_rows`).
        top_groups: ``(Q, m)`` int64 selected group indices.

    Returns:
        ``words (Q, m, bw, group)``, ``tie (Q, m, group)`` and
        ``ids (Q, m, group)``, all int32 (tie and id are stored as int32
        already, so no bit reinterpretation is needed).
    """
    q, m = top_groups.shape
    rows = rows_g.index_select(0, top_groups.reshape(-1)).reshape(q, m, bw + 2, group)
    return rows[:, :, :bw, :], rows[:, :, bw, :], rows[:, :, bw + 1, :]


def gather_refine_slots(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    ids: torch.Tensor,
    top_groups: torch.Tensor,
    *,
    group: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot twin of :func:`gather_refine_group_rows`, for ``tie`` /
    ``ids`` columns the grouped table does not hold (a ``where=`` filter).

    Group ``g`` is slots ``g * group .. g * group + group - 1`` (the
    kernels' contiguous grouping). Returns the same ``(words (Q, m, BW,
    group), tie (Q, m, group), ids (Q, m, group))``, words word-aligned.
    """
    q, m = top_groups.shape
    bw = sig_t.shape[0]
    slots = (
        top_groups[..., None] * group + torch.arange(group, device=sig_t.device)
    ).reshape(-1)
    words = sig_t.index_select(1, slots).reshape(bw, q, m, group).permute(1, 2, 0, 3)
    return words, tie[slots].reshape(q, m, group), ids[slots].reshape(q, m, group)


def gather_refine(sig_rows, sig_t, tie, ids, top_groups, *, num_bands, group, narrow_r):
    """``(words, tie, ids, narrow_r)`` of the selected groups: from the
    grouped table when there is one, else slot by slot (word-aligned)."""
    if sig_rows is not None:
        nw = narrow_words_count(num_bands, narrow_r) if narrow_r else sig_t.shape[0]
        return (*gather_refine_group_rows(sig_rows, top_groups, bw=nw, group=group), narrow_r)
    if ids is None:
        raise ValueError("sig_rows=None (per-slot refinement) needs the ids column")
    return (*gather_refine_slots(sig_t, tie, ids, top_groups, group=group), 0)


def refine_counts_vs_query(
    cwords: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    words: int,
    narrow_r: int,
    probes: int = 1,
) -> torch.Tensor:
    """Per-candidate collision counts of gathered refine rows vs queries.

    Args:
        cwords: ``(Q, m, nw, group)`` int32 gathered signature words —
            word-aligned (``nw = num_bands * words``) when ``narrow_r == 0``,
            else NARROW-packed (``32 // narrow_r`` bands per word, see
            `lshrs_tpu_torch.ops.bitpack.pack_words_narrow`).
        qwords: ``(Q, probes * num_bands * words)`` int32 probe-major,
            always word-aligned (packed narrow here when needed).

    Returns:
        ``(Q, m, group)`` int32 matching-band counts (any-probe semantics
        when ``probes > 1``).
    """
    bw = num_bands * words
    counts = None
    if narrow_r:
        q = qwords.shape[0]
        qn = pack_words_narrow(
            qwords.reshape(q * probes, bw), num_bands=num_bands, rows_per_band=narrow_r
        ).reshape(q, probes, -1)
        bpw = 32 // narrow_r
        mask = (1 << narrow_r) - 1
        for t in range(probes):
            for wi in range(cwords.shape[2]):
                cw = cwords[:, :, wi, :]
                qv = qn[:, t, wi][:, None, None]
                for j in range(min(bpw, num_bands - wi * bpw)):
                    sh = j * narrow_r
                    # Arithmetic shifts on int32 bit-views: the mask drops
                    # the sign extension, leaving band j's bits.
                    eq = ((cw >> sh) & mask) == ((qv >> sh) & mask)
                    counts = eq.to(torch.int32) if counts is None else counts + eq
        return counts
    for t in range(probes):
        for b in range(num_bands):
            col = t * bw + b * words
            eq = cwords[:, :, b * words, :] == qwords[:, col][:, None, None]
            for j in range(1, words):
                eq &= cwords[:, :, b * words + j, :] == qwords[:, col + j][:, None, None]
            counts = eq.to(torch.int32) if counts is None else counts + eq
    return counts


def collision_topk_grouped_core(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    num_bands: int,
    k: int,
    group: int,
    narrow_r: int = 0,
    probes: int = 1,
    ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (count desc, id asc) via group-max keys + refinement.

    Args:
        sig_t: ``(BW, C)`` int32 transposed signatures; C % group == 0.
        tie: ``(C,)`` int32 — ``S - 1 - global_id_rank`` for alive slots,
            -1 for dead (see :func:`global_tie_core`).
        qwords: ``(Q, probes * BW)`` int32 probe-major query words.
        sig_rows: ``(C // group, group * (nw + 2))`` grouped refine table
            (:func:`build_grouped_refine_rows`); ``nw = BW`` when
            ``narrow_r == 0``, else ``narrow_words_count(num_bands,
            narrow_r)`` narrow-packed words. ``None`` refines slot by slot
            from ``sig_t``, ``tie`` and ``ids`` (filtered queries: the
            table bakes in the unfiltered columns).
        probes: multi-probe variants per query; the count is the number of
            bands matching ANY variant.
        ids: ``(C,)`` int32 id column, -1 dead; needed only without
            ``sig_rows``.

    Returns:
        ``(counts, ids)``, each ``(Q, k)`` int32; zero-count tail entries
        carry id -1.
    """
    bw, c = sig_t.shape
    w = bw // num_bands
    scale = key_scale(c)
    ng = c // group
    gmax = group_max_keys(
        sig_t, tie, qwords, num_bands=num_bands, words=w, group=group,
        scale=scale, probes=probes,
    )
    top_groups = select_top_groups(gmax, min(k, ng))
    with span("lshrs.refine"):
        cwords, cand_tie, cand_ids, narrow_r = gather_refine(
            sig_rows, sig_t, tie, ids, top_groups,
            num_bands=num_bands, group=group, narrow_r=narrow_r,
        )
        counts = refine_counts_vs_query(
            cwords, qwords, num_bands=num_bands, words=w, narrow_r=narrow_r, probes=probes
        )
    with span("lshrs.topk"):
        return collision_final_topk(counts, cand_tie, cand_ids, k=k, scale=scale)


# Limit of kernel group_select (csrc/group_select.cu): the groups it keeps
# a row in its list in shared memory.
_SELECT_KERNEL_M = 256


def select_kernel_fits(m: int, ng: int) -> bool:
    """True when kernel :func:`group_select` takes the top ``m`` of ``ng``
    group maxima a query: every single-pass core's ``k`` and the cascade's
    pools up to 256 groups."""
    return 0 < m <= min(_SELECT_KERNEL_M, ng)


def group_select(gmax: torch.Tensor, m: int) -> torch.Tensor:
    """The group indices of the ``m`` largest keys of each row of ``gmax``
    in one pass over the row — kernel ``group_select`` (CUDA source
    ``csrc/group_select.cu``), one block a row; each launch counts in
    ``select_top_groups.launches``.

    Args:
        gmax: ``(Q, ng)`` int32 row-major group maxima (kernels B1, B2, B3).
        m: groups a row, within :func:`select_kernel_fits`.

    Returns:
        ``(Q, m)`` int64 in descending key order. The keys are
        ``torch.topk``'s bit for bit; among equal keys the kernel takes the
        lowest indices. CPU tensors take the plain version,
        ``torch.topk(gmax, m, dim=1).indices``.
    """
    if gmax.dtype != torch.int32:
        raise TypeError(f"gmax must be torch.int32; got {gmax.dtype}")
    if gmax.dim() != 2:
        raise ValueError(f"gmax must be (Q, ng); got shape {tuple(gmax.shape)}")
    q, ng = gmax.shape
    if not select_kernel_fits(m, ng):
        raise ValueError(
            f"the selection kernel takes 0 < m <= min({_SELECT_KERNEL_M}, ng); got m={m}, ng={ng}"
        )
    if not gmax.is_contiguous():
        raise ValueError("group_select: gmax must be contiguous")
    dev = _device(gmax)
    if dev.type == "cpu":
        return torch.topk(gmax, m, dim=1).indices
    out = torch.empty((q, m), dtype=torch.int64, device=dev)
    if q:
        _launch("lshrs_group_select", dev, gmax.data_ptr(), out.data_ptr(), q, ng, m)
        select_top_groups.launches += 1
    return out


def select_top_groups(gmax: torch.Tensor, m: int) -> torch.Tensor:
    """The ``m`` groups of largest key per query, ``(Q, m)`` int64, over the
    ``(Q, C / group)`` group maxima (the selection stage of the grouped
    collision and Hamming cores; span ``lshrs.select``): :func:`group_select`
    within :func:`select_kernel_fits`, else one flat ``torch.topk``.
    ``launches`` counts the kernel's launches. Alive keys are distinct and
    tied groups yield id -1 (the module docstring, step 2), so the order
    among equal keys never changes an answer."""
    with span("lshrs.select"):
        if select_kernel_fits(m, gmax.shape[1]):
            return group_select(gmax, m)
        return torch.topk(gmax, m, dim=1).indices


select_top_groups.launches = 0


def collision_final_topk(
    counts: torch.Tensor, cand_tie: torch.Tensor, cand_ids: torch.Tensor, *, k: int, scale: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Last stage of :func:`collision_topk_grouped_core`: the refined
    candidates' ``(count, tie)`` keys and their exact top-k.

    Args:
        counts / cand_tie / cand_ids: ``(Q, m, group)`` int32 recounts
            (:func:`refine_counts_vs_query`), ties and ids of the gathered
            candidates.
        scale: ``key_scale(C)``.

    Returns:
        ``(counts, ids)``, each ``(Q, k)`` int32; zero-count tail entries
        carry id -1.
    """
    q = counts.shape[0]
    counts = counts.reshape(q, -1)
    mg = counts.shape[1]
    cand_tie = cand_tie.reshape(q, mg)
    key = counts * (cand_tie >= 0) * scale + cand_tie.clamp(min=0)

    k_eff = min(k, mg)
    top_key, top_pos = torch.topk(key, k_eff, dim=1)
    sel_counts = top_key // scale
    picked = cand_ids.reshape(q, mg).gather(1, top_pos)
    sel_ids = torch.where(sel_counts > 0, picked, -1)
    if k_eff < k:
        sel_counts = torch.nn.functional.pad(sel_counts, (0, k - k_eff))
        sel_ids = torch.nn.functional.pad(sel_ids, (0, k - k_eff), value=-1)
    return sel_counts, sel_ids


def collision_counts_core(
    sig_t: torch.Tensor,
    ids: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    chunk: int,
    probes: int = 1,
) -> torch.Tensor:
    """Full per-slot collision counts, ``(Q, C)`` int32 (0 at dead slots).

    The unbounded-candidate paths (the full rerank engine, ``top_k=None``)
    need every colliding candidate, as the reference's candidate dict
    holds them. ``chunk`` slots go through per step (see
    :func:`count_step`).
    """
    c = sig_t.shape[1]
    out = torch.empty((qwords.shape[0], c), dtype=torch.int32, device=sig_t.device)
    for s in range(0, c, chunk):
        e = min(c, s + chunk)
        counts = band_counts_t(sig_t[:, s:e], qwords, num_bands, probes)
        out[:, s:e] = torch.where(ids[None, s:e] >= 0, counts, 0)
    return out


def collision_nnz_core(
    sig_t: torch.Tensor,
    ids: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    chunk: int,
    probes: int = 1,
) -> torch.Tensor:
    """Per-query colliding-candidate count, ``(Q,)`` int32.

    Each step reduces its ``(Q, chunk)`` counts at once, so the ``(Q, C)``
    matrix never exists: the completeness probe of the bounded candidate
    enumeration (``top_k=None``) reads back O(Q).
    """
    c = sig_t.shape[1]
    acc = torch.zeros((qwords.shape[0],), dtype=torch.int32, device=sig_t.device)
    for s in range(0, c, chunk):
        e = min(c, s + chunk)
        counts = band_counts_t(sig_t[:, s:e], qwords, num_bands, probes)
        acc += ((counts > 0) & (ids[None, s:e] >= 0)).sum(dim=1, dtype=torch.int32)
    return acc


def compute_chunk_ranks(ids: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Rank of each slot's id within its chunk (dead slots included),
    ``(C,)`` int32: order-isomorphic to the ids among a chunk's slots, all
    the chunked cores need for exact id tie-breaking. The sort is stable,
    like the reference's ``jnp.argsort``, so duplicate ids (``dedupe=False``)
    rank by slot."""
    c = ids.shape[0]
    order = torch.argsort(ids.reshape(c // chunk, chunk), dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(chunk, device=ids.device).expand_as(order))
    return ranks.reshape(c).to(torch.int32)


def global_tie_core(ids: torch.Tensor) -> torch.Tensor:
    """Global tie-break keys: ``S - 1 - rank(id)`` for alive slots, -1 dead.

    Ranks are over all slots (dead ids sort as -1, ahead of alive ones).
    The sort is stable, like the reference's ``jnp.argsort``, so duplicate
    alive ids (``dedupe=False``) rank by slot order in both packages.
    """
    c = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(c, device=ids.device)
    return torch.where(ids >= 0, key_scale(c) - 1 - rank, -1).to(torch.int32)
