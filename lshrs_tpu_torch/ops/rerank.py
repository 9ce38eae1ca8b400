"""Cosine rerank over the device-resident payload: the top-p slice.

With ``store_vectors=True`` the raw vectors live beside the signatures,
so top-p rerank runs on the device and only the top ``max_out``
``(id, cosine)`` pairs and the candidate counts reach the host. Two
formulations, as in the reference package (`lshrs_tpu.ops.rerank`):

- **full** (:func:`rerank_topp_core`, :func:`rerank_topp_batch_core`): one
  ``(Q, C)`` cosine matmul over the whole store, masked by the collision
  counts (`lshrs_tpu_torch.ops.scan.collision_counts_core`);
- **gather** (:func:`rerank_topp_gather_core`): kernel B1's group maxima
  select the ``max_candidates`` most-colliding slots, and only their
  payload rows are gathered and reranked. It flags, per query, whether the
  whole colliding set was covered (then its result is the full engine's).

Ordering: ``(cosine desc, id asc)``, as two stable sorts (minor key
first) — torch has no two-key sort like ``jax.lax.sort(num_keys=2)``.

Precision contract (the reference's): a float32 query against a float32
payload is a true float32 product, so TF32 must be off on the card (the
wrappers raise otherwise). A bfloat16 or int8 payload takes a bfloat16
query, rounded once, as the reference does; the products are computed in
float32 on the upcast values, where they are exact (bf16 x bf16 and
int8 x bf16 products fit float32's mantissa), where ``torch.matmul`` on
two bf16 tensors would round the dots to bf16. An int8 payload's ``pnorm``
is the norm of its integer rows, so the per-row scale cancels out of the
cosine. The rerank matmuls are plain ``torch.matmul`` / ``torch.bmm``, as
the reference leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from lshrs_tpu_torch.ops.group_max import group_max_keys, key_scale
from lshrs_tpu_torch.ops.scan import gather_refine, refine_counts_vs_query
from lshrs_tpu_torch.utils.trace import span

__all__ = [
    "merge_topp_pools",
    "rerank_topp_batch_core",
    "rerank_topp_core",
    "rerank_topp_gather_core",
]

_INT32_MAX = 2**31 - 1
# The full engine's exact sort runs past this prefix length (or on stores
# no larger); below it, a value top-k first (the reference's fast path).
_TOPK_FAST_MAX = 1024
# Payload slots per step of the full engine's cosine matmul: bounds the
# float32 upcast of a bf16 or int8 payload (2**18 x 768 x 4 B = 805 MB,
# where a 1M-slot int8 payload upcast whole would be 3 GB).
_DOT_SLOTS = 1 << 18


def _require_f32_matmul(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the cosine rerank "
            "needs full float32 matmuls (TF32 rounding reorders near-ties)"
        )


def _query_operands(
    qvecs: torch.Tensor, payload_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(qd, qn)``: the float32 matmul operand and the query norms.

    A bf16 or int8 payload takes the query rounded to bf16 (the
    reference's ``qvecs.astype(bfloat16)``); the norm is always that of
    the query as it arrived (float32, or the bf16 wire's values).
    """
    qf = qvecs.to(torch.float32)
    if payload_dtype in (torch.bfloat16, torch.int8):
        qd = qvecs.to(torch.bfloat16).to(torch.float32)
    else:
        qd = qf
    return qd, torch.sqrt(torch.sum(qf * qf, dim=-1))


def _payload_dots(payload: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """``(Q, C)`` float32 dots of every payload row with every query."""
    _require_f32_matmul(qd)
    if payload.dtype == torch.float32:
        return qd @ payload.T
    c = payload.shape[0]
    dots = torch.empty((qd.shape[0], c), dtype=torch.float32, device=payload.device)
    for s in range(0, c, _DOT_SLOTS):
        e = min(c, s + _DOT_SLOTS)
        dots[:, s:e] = qd @ payload[s:e].to(torch.float32).T
    return dots


def _order(sims: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise permutation sorting by ``(cosine desc, id asc)``; entries
    outside ``mask`` go last. Two stable sorts, minor key first."""
    tie = torch.where(mask, ids, _INT32_MAX)
    order = torch.argsort(tie, dim=-1, stable=True)
    neg = torch.where(mask, -sims, float("inf")).gather(-1, order)
    return order.gather(-1, torch.argsort(neg, dim=-1, stable=True))


def merge_topp_pools(
    pool_ids: torch.Tensor, pool_sims: torch.Tensor, *, out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge pooled ``(id, cosine)`` prefixes (id -1 = empty) to the first
    ``out`` by (cosine desc, id asc): exact whenever every list in the pool
    is its part's own top ``out``, since cosine is an absolute key."""
    valid = pool_ids >= 0
    order = _order(pool_sims, pool_ids, valid)[:, :out]
    return torch.where(valid.gather(1, order), pool_ids.gather(1, order), -1), pool_sims.gather(1, order)


def _rank_full(
    payload, pnorm, ids, counts, qvecs, *, max_out: int, fast_path: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    qd, qn = _query_operands(qvecs, payload.dtype)
    sims = _payload_dots(payload, qd) / torch.clamp(pnorm[None, :] * qn[:, None], min=1e-30)
    mask = (counts > 0) & (ids >= 0)[None, :]
    n = mask.sum(dim=1, dtype=torch.int32)
    q, c = sims.shape
    out = min(max_out, c)
    if fast_path and out <= _TOPK_FAST_MAX < c:
        # Value top-k of the masked cosines, then the exact two-key order
        # of the selection. Order among exactly equal cosines straddling
        # the cut is unspecified (so it is in the reference).
        top_sims, top_pos = torch.topk(torch.where(mask, sims, float("-inf")), out, dim=1)
        sel_ids = ids[top_pos]
        order = _order(top_sims, sel_ids, mask.gather(1, top_pos))
        sorted_sims, sorted_ids = top_sims.gather(1, order), sel_ids.gather(1, order)
    else:
        order = _order(sims, ids.expand(q, c), mask)[:, :out]
        sorted_sims, sorted_ids = sims.gather(1, order), ids[order]
    alive = torch.arange(out, device=n.device)[None, :] < n[:, None]
    return torch.where(alive, sorted_ids, -1), sorted_sims, n


def rerank_topp_core(
    payload: torch.Tensor,
    pnorm: torch.Tensor,
    ids: torch.Tensor,
    counts_row: torch.Tensor,
    qvec: torch.Tensor,
    *,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank one query's colliding candidates by cosine, on the device.

    Args:
        payload: ``(C, dim)`` float32, bfloat16 or int8 rows (dead slots
            arbitrary).
        pnorm: ``(C,)`` float32 norms of the stored rows.
        ids: ``(C,)`` int32, -1 dead.
        counts_row: ``(C,)`` int32 band-collision counts of this query.
        qvec: ``(dim,)`` float32 query.
        max_out: ranked prefix length to return.

    Returns:
        ``(ids (out,), sims (out,), n ())`` with ``out = min(max_out, C)``:
        candidates by (cosine desc, id asc); entries past ``n`` carry
        id -1 (their sims are unspecified).
    """
    out_ids, sims, n = _rank_full(
        payload, pnorm, ids, counts_row[None, :], qvec[None, :],
        max_out=max_out, fast_path=False,
    )
    return out_ids[0], sims[0], n[0]


def rerank_topp_batch_core(
    payload: torch.Tensor,
    pnorm: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    qvecs: torch.Tensor,
    *,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched :func:`rerank_topp_core`: one cosine matmul for all queries.

    Args:
        counts: ``(Q, C)`` int32 per-query collision counts.
        qvecs: ``(Q, dim)`` float32 (or bfloat16 wire) queries.

    Returns:
        ``(ids (Q, out), sims (Q, out), n (Q,))``, ordered by
        (cosine desc, id asc). For ``out <= 1024 < C`` a value top-k runs
        before the exact sort (the reference's fast path).
    """
    return _rank_full(payload, pnorm, ids, counts, qvecs, max_out=max_out, fast_path=True)


def rerank_topp_gather_core(
    payload: torch.Tensor,
    pnorm: torch.Tensor,
    tie: torch.Tensor,
    sig_t: torch.Tensor,
    qwords: torch.Tensor,
    qvecs: torch.Tensor,
    sig_rows: torch.Tensor | None,
    *,
    num_bands: int,
    max_out: int,
    max_candidates: int,
    group: int,
    narrow_r: int = 0,
    probes: int = 1,
    ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate-gather top-p rerank: cost scales with candidates, not
    capacity.

        1. kernel B1 (`lshrs_tpu_torch.ops.group_max.group_max_keys`): the
           max ``(count, tie)`` key of each contiguous group of slots;
        2. the top ``M = max_candidates`` groups by max key (a flat
           ``torch.topk``: alive keys are distinct). Every group holding a
           colliding slot outranks every collision-free group, so when a
           selected group's max is below the key scale the colliding set
           was covered in full;
        3. recount the selected groups' slots from the grouped refine
           table and keep the top M slots by ``(count, tie)``;
        4. gather only those slots' payload rows, ``(Q, M, dim)``, and
           rerank them with one batched matmul and the exact
           (cosine desc, id asc) sort.

    Args:
        payload / pnorm / tie / sig_t: store state (see `DeviceStore`).
        qwords: ``(Q, probes * BW)`` int32 query words, probe-major;
            with ``probes > 1`` the candidate set holds any-probe band
            matches.
        qvecs: ``(Q, dim)`` float32 (or bfloat16 wire) queries.
        sig_rows: the grouped refine table
            (`lshrs_tpu_torch.ops.scan.build_grouped_refine_rows`),
            narrow-packed when ``narrow_r``. ``None`` refines slot by slot
            from ``sig_t``, ``tie`` and ``ids`` (filtered queries: the
            table bakes in the unfiltered columns).
        ids: ``(C,)`` int32 id column, needed only without ``sig_rows``.
        max_out: ranked prefix length per query.
        max_candidates: M, groups refined and slots reranked per query.
        group: slots per group (contiguous), a power of two dividing C.

    Returns:
        ``(ids (Q, max_out), sims (Q, max_out), n (Q,), exact (Q,))``.
        ``exact[q]`` is True iff query q's whole colliding set was
        reranked (then the result is the full engine's); otherwise the
        ranking covers the M candidates with the most band collisions and
        ``n`` is a lower bound.
    """
    bw, c = sig_t.shape
    q = qwords.shape[0]
    w = bw // num_bands
    scale = key_scale(c)
    ng = c // group

    # -- stage 1: group-max keys (kernel B1) --------------------------------
    gmax = group_max_keys(
        sig_t, tie, qwords, num_bands=num_bands, words=w, group=group,
        scale=scale, probes=probes,
    )

    # -- stage 2: top-M groups + coverage -------------------------------------
    # B1 biases dead slots to keys <= 0 and collision-free alive keys are
    # the tie (< scale), so a selected max below scale is a collision-free
    # group: every colliding group was selected.
    m = min(max_candidates, ng)
    with span("lshrs.select"):
        gsel, top_groups = torch.topk(gmax, m, dim=1)
    covered = (gsel.amin(dim=1) < scale) | (m == ng)

    # -- stage 3: refine the selected groups ----------------------------------
    mg = m * group
    slots = (top_groups[..., None] * group + torch.arange(group, device=sig_t.device)).reshape(q, mg)
    with span("lshrs.refine"):
        cwords, cand_tie, cand_ids, narrow_r = gather_refine(
            sig_rows, sig_t, tie, ids, top_groups,
            num_bands=num_bands, group=group, narrow_r=narrow_r,
        )
        counts = refine_counts_vs_query(
            cwords, qwords, num_bands=num_bands, words=w, narrow_r=narrow_r, probes=probes
        ).reshape(q, mg)
    cand_tie = cand_tie.reshape(q, mg)
    alive = cand_tie >= 0
    n = ((counts > 0) & alive).sum(dim=1, dtype=torch.int32)  # exact iff covered

    # -- stage 4: top-M slots by (count, tie), gather payload, rerank ---------
    m_slots = min(max_candidates, mg)
    key = counts * alive * scale + cand_tie.clamp(min=0)
    top_key, top_pos = torch.topk(key, m_slots, dim=1)
    sel_slots = slots.gather(1, top_pos)
    sel_ids = cand_ids.reshape(q, mg).gather(1, top_pos)
    exact = covered & (n <= m_slots)

    # The gather moves the payload's storage dtype (int8 moves a quarter of
    # float32's bytes); rows upcast only for the small (Q, M, dim) block.
    flat = sel_slots.reshape(-1)
    rows = payload.index_select(0, flat).reshape(q, m_slots, -1).to(torch.float32)
    qd, qn = _query_operands(qvecs, payload.dtype)
    _require_f32_matmul(qd)
    dots = torch.bmm(rows, qd[:, :, None])[:, :, 0]
    sims = dots / torch.clamp(pnorm[flat].reshape(q, m_slots) * qn[:, None], min=1e-30)

    mask = top_key >= scale  # selected slots that collide
    order = _order(sims, sel_ids, mask)
    out = min(max_out, m_slots)
    order = order[:, :out]
    # Valid = colliding candidates actually selected (== n when exact).
    valid = mask.sum(dim=1)
    alive_out = torch.arange(out, device=n.device)[None, :] < valid[:, None]
    out_ids = torch.where(alive_out, sel_ids.gather(1, order), -1)
    out_sims = sims.gather(1, order)
    if out < max_out:
        out_ids = torch.nn.functional.pad(out_ids, (0, max_out - out), value=-1)
        out_sims = torch.nn.functional.pad(out_sims, (0, max_out - out))
    return out_ids, out_sims, n, exact
