"""Fused group-max key kernels: the query hot loop (kernels B1, B2, B3).

The kernels score every (query, slot) pair, pack the score and the
slot's id-rank tie into one int32 selection key, and write only the max
key of each group of ``group`` CONTIGUOUS slots — ``(Q, C / group)``
instead of ``(Q, C)``. Because alive keys are globally distinct (the tie
term embeds the slot's id-rank), the top-k groups by max provably hold
every true top-k slot, so the selection stage refines only those groups
exactly (`lshrs_tpu_torch.ops.scan`, `lshrs_tpu_torch.ops.hamming`).

- **B1** :func:`group_max_keys` — band-collision count:
  ``key = count * S + bias``, bias ``tie`` alive / ``-B * S`` dead.
  CUDA source ``csrc/collision_group_max.cu``.
- **B2** :func:`hamming_group_max_keys` — int8 bitplane dot:
  ``key = ((dot + offset) >> shift) * S + bias``, bias ``tie + S`` alive
  / ``-maxscaled * S`` dead, on operands zero-padded to a multiple of 16
  (the store: 32) columns. CUDA source ``csrc/hamming_group_max.cu``
  (wgmma on int8 tensor cores, TMA loads).
- **B3** :func:`hamming_packed_group_max_keys` — Hamming over the low
  ``word_bits`` bits of each packed word: ``key = bias - ham * S``, bias
  ``(P + 1) * S + tie`` alive / ``0`` dead. CUDA source
  ``csrc/hamming_packed_group_max.cu``: B2's pipeline, the store's words
  expanded to +-1 tiles in shared memory and the queries by
  :func:`packed_operand`, so ``dot = n - 2 * ham`` over ``n = BW *
  word_bits`` columns. It reads a block or the live prefix of a store's
  words in place, rows a store's C apart (:func:`packed_words_stride`).

Each public wrapper takes its plain PyTorch version (``*_ref``) only for
tensors on the CPU, launches its hand-written kernel for CUDA tensors,
and raises otherwise; it never falls back. Each wrapper counts the
kernel launches it makes in its ``launches`` attribute (B1 also by
``(BW, probes)`` in ``launches_by_shape`` and by the shape ``(BW, words,
probes)`` in ``launches_by_template``, B2 by its key packing
``(width, offset, shift)`` in ``launches_by_packing``, B3 by ``(BW,
word_bits)`` in ``launches_by_shape``). The plain version or the launch
runs inside the span ``lshrs.b1``, ``lshrs.b2`` or ``lshrs.b3``
(`lshrs_tpu_torch.utils.trace`).

Key packing requires ``(num_bands + 1) * S < 2**31`` (B1),
``(maxscaled + 2) * S < 2**31`` (B2) and ``(P + 2) * S < 2**31`` (B3)
with ``S = key_scale(C)``; larger
stores are not served by these kernels (ROADMAP: int64 keys or the
chunked fallback).
"""

from __future__ import annotations

import collections

import torch

from lshrs_tpu_torch.ops import _build
from lshrs_tpu_torch.ops.bitpack import popcount31, popcount32
from lshrs_tpu_torch.utils.trace import span

__all__ = [
    "asymmetric_shift",
    "band_counts_t",
    "group_max_keys",
    "group_max_keys_ref",
    "hamming_group_max_keys",
    "hamming_group_max_keys_ref",
    "hamming_packed_group_max_keys",
    "hamming_packed_group_max_keys_ref",
    "key_scale",
    "packed_operand",
    "packed_width",
    "packed_words_stride",
    "supports_fast_path",
]

# Slots per step of the plain B2 and B3 versions: bounds their (Q, slots)
# temporaries without changing the result.
_REF_SLOTS = 1 << 16


def key_scale(capacity: int) -> int:
    """S — the multiplier separating count from tie bits in packed keys."""
    return 1 << max(1, (capacity - 1).bit_length())


def supports_fast_path(num_bands: int, capacity: int) -> bool:
    """True when (count, tie) packs into a positive int32."""
    return (num_bands + 1) * key_scale(capacity) < 2**31


def asymmetric_shift(num_perm: int, capacity: int, qmax: int = 127) -> int:
    """Smallest right-shift packing the asymmetric B2 key into int32.

    Quantised query coordinates in ``[-qmax, qmax]`` against +-1 planes
    give dots in ``[-P * qmax, P * qmax]``; with ``offset = P * qmax`` the
    scaled term ``(dot + offset) >> shift`` must satisfy
    ``((2 * P * qmax) >> shift + 2) * key_scale(capacity) < 2**31``.
    """
    scale = key_scale(capacity)
    budget = (2**31) // scale - 2
    if budget <= 0:
        raise ValueError(f"capacity {capacity} exceeds int32 key packing")
    shift = 0
    while (2 * num_perm * qmax) >> shift > budget:
        shift += 1
    return shift


def _collision_key_bias(
    tie: torch.Tensor, *, scale: int, num_bands: int
) -> torch.Tensor:
    """Per-slot key bias of B1: ``tie`` alive, ``-num_bands * scale`` dead
    (a dead key ``count*S - B*S <= 0`` never beats an alive one)."""
    return torch.where(tie >= 0, tie, -num_bands * scale)


def _hamming_key_bias(
    tie: torch.Tensor, *, scale: int, maxscaled: int
) -> torch.Tensor:
    """Per-slot key bias of B2. ``maxscaled`` is the largest value of the
    scaled-dot term — ``(2 * offset) >> shift`` — so dead keys land at or
    below zero, under every alive key (``>= scale``)."""
    return torch.where(tie >= 0, tie + scale, -maxscaled * scale)


def _hamming_offset(width: int, offset: int | None, num_perm: int | None) -> int:
    """B2's key offset: ``offset`` if given, else the true signature width
    ``num_perm`` (default: the operands' width ``width``)."""
    if num_perm is not None and not 0 < num_perm <= width:
        raise ValueError(f"num_perm={num_perm} must be in (0, {width}], the operands' width")
    if offset is not None:
        return offset
    return width if num_perm is None else num_perm


# (device, word_bits) -> (the bit shifts, the -1 / +1 pair) of packed_operand.
_OPERAND_CONSTANTS: dict = {}


def _operand_constants(device: torch.device, word_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device, word_bits)
    if key not in _OPERAND_CONSTANTS:
        _OPERAND_CONSTANTS[key] = (
            torch.arange(word_bits, dtype=torch.int32, device=device),
            torch.tensor([-1, 1], dtype=torch.int8, device=device),
        )
    return _OPERAND_CONSTANTS[key]


def packed_width(bw: int, word_bits: int) -> int:
    """Columns K of kernel B3's +-1 operands: ``BW * word_bits`` rounded up
    to a multiple of 32, the row width B2's pipeline takes."""
    return -(-bw * word_bits // 32) * 32


def packed_operand(
    words: torch.Tensor, *, word_bits: int = 32, width: int | None = None
) -> torch.Tensor:
    """Packed int32 words ``(n, BW)`` -> ``(n, width)`` int8 +-1 operand.

    Column ``w * word_bits + b`` is +1 where bit ``b`` of word ``w`` is set
    and -1 where it is clear (the bits above ``word_bits`` are left out);
    columns from ``BW * word_bits`` on are zero. This is kernel B3's column
    order: its queries go to the kernel in this form, and its slots are
    expanded the same way on the card. With one word per band
    (``rows_per_band <= 32``) and ``word_bits = rows_per_band`` it equals
    the store's bitplanes (`lshrs_tpu_torch.ops.hamming.unpack_bitplanes`).
    ``width`` defaults to :func:`packed_width`.
    """
    n, bw = words.shape
    nbits = bw * word_bits
    width = packed_width(bw, word_bits) if width is None else width
    if width < nbits:
        raise ValueError(f"width={width} is below BW * word_bits = {nbits}")
    shifts, pm1 = _operand_constants(words.device, word_bits)
    # (word >> s) & 1 is bit s even under the arithmetic shift of int32;
    # three launches in all, as the wrapper builds this for every call.
    bits = (words.reshape(n, bw, 1) >> shifts) & 1
    out = pm1.index_select(0, bits.reshape(-1)).reshape(n, nbits)
    if width == nbits:
        return out
    return torch.nn.functional.pad(out, (0, width - nbits))


def _hamming_packed_key_bias(
    tie: torch.Tensor, *, scale: int, num_perm: int
) -> torch.Tensor:
    """Per-slot key bias of B3: ``(P + 1) * scale + tie`` alive (the key
    ``(P + 1 - ham) * scale + tie`` then equals B2's), ``0`` dead (a dead
    key ``-ham * scale <= 0`` is under every alive key, ``>= scale``)."""
    return torch.where(tie >= 0, (num_perm + 1) * scale + tie, 0)


def band_counts_t(
    sig_t: torch.Tensor, qwords: torch.Tensor, num_bands: int, probes: int = 1
) -> torch.Tensor:
    """Collision counts, transposed layout (plain PyTorch).

    Args:
        sig_t: ``(BW, C)`` int32 packed signatures.
        qwords: ``(Q, probes * BW)`` int32 query signatures, probe-major
            (probe t's band-b word j at ``t*BW + b*w + j``).
    Returns:
        ``(Q, C)`` int32 — number of bands matching ANY probe variant.
        Still ``<= num_bands``: a band's variants are pairwise distinct,
        so a slot's band words equal at most one of them and the sum over
        probes equals the per-band OR.
    """
    bw = sig_t.shape[0]
    w = bw // num_bands
    counts = None
    for t in range(probes):
        for b in range(num_bands):
            col = t * bw + b * w
            eq = sig_t[b * w][None, :] == qwords[:, col][:, None]
            for j in range(1, w):
                eq &= sig_t[b * w + j][None, :] == qwords[:, col + j][:, None]
            counts = eq.to(torch.int32) if counts is None else counts + eq
    return counts


def _device(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device; got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}; got {tuple(t.shape)}")


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed (cudaError {rc})")


def group_max_keys_ref(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    words: int,
    group: int,
    scale: int,
    probes: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (see :func:`group_max_keys`)."""
    counts = band_counts_t(sig_t, qwords, num_bands, probes)
    bias = _collision_key_bias(tie, scale=scale, num_bands=num_bands)
    key = counts * scale + bias[None, :]
    q, c = key.shape
    return key.reshape(q, c // group, group).amax(-1)


def group_max_keys(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_bands: int,
    words: int,
    group: int,
    scale: int,
    probes: int = 1,
) -> torch.Tensor:
    """Per-group maxima of packed (count, tie) selection keys — kernel B1.

    Args:
        sig_t: ``(num_bands * words, C)`` int32 transposed signatures.
        tie: ``(C,)`` int32 — ``S - 1 - rank`` for alive slots, ``-1`` for
            dead slots.
        qwords: ``(Q, probes * num_bands * words)`` int32, probe-major;
            any Q (the CUDA kernel launches once per 65,535 blocks of
            queries).
        group: slots per group, a power of two dividing C (at least 4 for
            the CUDA kernel).
        scale: ``key_scale(C)``.
        probes: multi-probe variants per query (1 = standard); the count
            is the number of bands matching ANY variant.

    Returns:
        ``(Q, C // group)`` int32 group-max keys; group ``g`` is slots
        ``g*group .. g*group + group - 1``.
    """
    bw, c = sig_t.shape
    q = qwords.shape[0]
    if bw != num_bands * words:
        raise ValueError(f"sig_t has {bw} rows; expected num_bands * words = {num_bands * words}")
    _check("sig_t", sig_t, torch.int32, (bw, c))
    _check("tie", tie, torch.int32, (c,))
    _check("qwords", qwords, torch.int32, (q, probes * bw))
    if group <= 0 or group & (group - 1) or c % group:
        raise ValueError(f"group must be a power of two dividing C={c}; got {group}")
    dev = _device(sig_t, tie, qwords)
    if dev.type == "cpu":
        with span("lshrs.b1"):
            return group_max_keys_ref(
                sig_t, tie, qwords, num_bands=num_bands, words=words,
                group=group, scale=scale, probes=probes,
            )
    if not (sig_t.is_contiguous() and tie.is_contiguous() and qwords.is_contiguous()):
        raise ValueError("group_max_keys: CUDA inputs must be contiguous")
    if group < 4:
        raise ValueError(f"the CUDA kernel needs group >= 4; got {group}")
    with span("lshrs.b1"):
        out = torch.empty((q, c // group), dtype=torch.int32, device=dev)
        if q == 0:
            return out
        _launch(
            "lshrs_collision_group_max", dev,
            sig_t.data_ptr(), tie.data_ptr(), qwords.data_ptr(), out.data_ptr(),
            q, c, bw, words, probes, group, scale, num_bands,
        )
    group_max_keys.launches += 1
    group_max_keys.launches_by_shape[bw, probes] += 1
    group_max_keys.launches_by_template[bw, words, probes] += 1
    return out


group_max_keys.launches = 0
# The same launches, by (band words BW, probes).
group_max_keys.launches_by_shape = collections.Counter()
# ... and by the shape (BW, words per band W, probes), whichever of the
# kernel's instantiations served it: 8 x 32 and 4 x 64 both hold 8 band
# words, in one and two words a band.
group_max_keys.launches_by_template = collections.Counter()


def hamming_group_max_keys_ref(
    planes: torch.Tensor,
    tie: torch.Tensor,
    qbits: torch.Tensor,
    *,
    group: int,
    scale: int,
    offset: int | None = None,
    shift: int = 1,
    num_perm: int | None = None,
    dead_bias: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (see :func:`hamming_group_max_keys`).

    The dot is a float32 matmul of the int8 operands, exact because
    ``|dot| <= P * 127 < 2**24``; slots go through in blocks of
    ``_REF_SLOTS`` to bound the ``(Q, slots)`` temporaries. ``dead_bias``
    replaces the dead slots' bias ``-((2 * offset) >> shift) * scale``
    (kernel B3's key is B2's with ``dead_bias = -P * scale``).
    """
    c, p = planes.shape
    q = qbits.shape[0]
    if p * 127 >= 2**24:
        raise ValueError(f"P={p} is too wide for an exact float32 dot")
    off = _hamming_offset(p, offset, num_perm)
    bias = _hamming_key_bias(tie, scale=scale, maxscaled=(2 * off) >> shift)
    if dead_bias is not None:
        bias = torch.where(tie >= 0, bias, dead_bias)
    qf = qbits.to(torch.float32)
    out = torch.empty((q, c // group), dtype=torch.int32, device=planes.device)
    step = group * max(1, _REF_SLOTS // group)
    for s in range(0, c, step):
        e = min(c, s + step)
        dots = (qf @ planes[s:e].to(torch.float32).T).to(torch.int32)
        key = ((dots + off) >> shift) * scale + bias[None, s:e]
        out[:, s // group : e // group] = key.reshape(q, (e - s) // group, group).amax(-1)
    return out


def hamming_group_max_keys(
    planes: torch.Tensor,
    tie: torch.Tensor,
    qbits: torch.Tensor,
    *,
    group: int,
    scale: int,
    offset: int | None = None,
    shift: int = 1,
    num_perm: int | None = None,
) -> torch.Tensor:
    """Per-group maxima of packed (scaled-dot, tie) keys — kernel B2.

    Args:
        planes: ``(C, Pp)`` int8 +-1 store bitplanes; columns past the
            true width are zero (the store pads ``Pp`` to a multiple of 32).
        tie: ``(C,)`` int32 tie keys (-1 dead).
        qbits: ``(Q, Pp)`` int8 query operand (+-1 bitplanes, or quantised
            coordinates for asymmetric ranking), padded like ``planes``.
        group: slots per group, a power of two dividing C (16, 32, 64 or
            128 for the CUDA kernel, which also needs ``Pp % 16 == 0`` and
            16-byte aligned operands: its TMA row stride).
        offset / shift: key packing ``((dots+offset)>>shift)*scale + tie``
            — default (None, 1) is symmetric Hamming, ``offset = num_perm``.
        num_perm: the true signature width P (default ``Pp``); zero
            columns add nothing to the dot but would shift the default
            offset.

    Returns:
        ``(Q, C // group)`` int32 group-max keys, contiguous groups.
    """
    c, p = planes.shape
    q = qbits.shape[0]
    _check("planes", planes, torch.int8, (c, p))
    _check("tie", tie, torch.int32, (c,))
    _check("qbits", qbits, torch.int8, (q, p))
    if group <= 0 or group & (group - 1) or c % group:
        raise ValueError(f"group must be a power of two dividing C={c}; got {group}")
    off = _hamming_offset(p, offset, num_perm)
    dev = _device(planes, tie, qbits)
    if dev.type == "cpu":
        with span("lshrs.b2"):
            return hamming_group_max_keys_ref(
                planes, tie, qbits, group=group, scale=scale, offset=off, shift=shift
            )
    if not (planes.is_contiguous() and tie.is_contiguous() and qbits.is_contiguous()):
        raise ValueError("hamming_group_max_keys: CUDA inputs must be contiguous")
    if planes.data_ptr() % 16 or qbits.data_ptr() % 16:
        raise ValueError("hamming_group_max_keys: planes and qbits must be 16-byte aligned")
    if group not in (16, 32, 64, 128) or p % 16:
        raise ValueError(
            f"the CUDA kernel needs group in (16, 32, 64, 128) and a row width that is a "
            f"multiple of 16 bytes (pad P with zero columns, pass num_perm=); "
            f"got group={group}, width={p}"
        )
    with span("lshrs.b2"):
        out = torch.empty((q, c // group), dtype=torch.int32, device=dev)
        if q == 0:
            return out
        _launch(
            "lshrs_hamming_group_max", dev,
            planes.data_ptr(), tie.data_ptr(), qbits.data_ptr(), out.data_ptr(),
            q, c, p, group, scale, off, shift, -((2 * off) >> shift) * scale,
        )
    hamming_group_max_keys.launches += 1
    hamming_group_max_keys.launches_by_packing[p, off, shift] += 1
    return out


hamming_group_max_keys.launches = 0
# The same launches, by (operand width, offset, shift): which key packing
# a path reached (symmetric, asymmetric per coordinate wire, the
# cascade's coarse pass).
hamming_group_max_keys.launches_by_packing = collections.Counter()


def packed_words_stride(sig_t: torch.Tensor) -> int:
    """The row stride ``ld`` (in words) at which kernel B3 reads ``sig_t``.

    ``sig_t`` is ``(BW, L)`` int32 with contiguous slots and rows ``ld >=
    L`` words apart: a store's whole words (``ld = L``), or one block or
    the live prefix of them, ``words[:, s:e]`` (``ld`` = the store's C).
    The kernel's TMA needs the base and ``4 * ld`` at multiples of 16
    bytes. Raises ``ValueError`` for any other layout or alignment.
    """
    bw, n = sig_t.shape
    ld = sig_t.stride(0) if bw > 1 else n
    if sig_t.stride(1) != 1 or ld < n:
        raise ValueError(
            "hamming_packed_group_max_keys: sig_t must have contiguous slots and rows "
            f"ld >= L apart; got shape {tuple(sig_t.shape)}, strides {sig_t.stride()}"
        )
    if sig_t.data_ptr() % 16 or ld % 4:
        raise ValueError(
            "hamming_packed_group_max_keys: sig_t must be 16-byte aligned, at its base and "
            f"in its row stride; got base % 16 = {sig_t.data_ptr() % 16}, ld = {ld}"
        )
    return ld


def hamming_packed_group_max_keys_ref(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_perm: int,
    group: int,
    scale: int,
    word_bits: int = 32,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B3 (see
    :func:`hamming_packed_group_max_keys`): XOR, the low ``word_bits``
    bits, popcount; slots go through in blocks of ``_REF_SLOTS`` to bound
    the ``(Q, slots)`` temporaries."""
    bw, c = sig_t.shape
    q = qwords.shape[0]
    bias = _hamming_packed_key_bias(tie, scale=scale, num_perm=num_perm)
    mask = (1 << word_bits) - 1

    def pop(x):
        # Below 32 bits the masked XOR is non-negative: int32 arithmetic.
        return popcount32(x) if word_bits == 32 else popcount31(x & mask)

    out = torch.empty((q, c // group), dtype=torch.int32, device=sig_t.device)
    step = group * max(1, _REF_SLOTS // group)
    for s in range(0, c, step):
        e = min(c, s + step)
        ham = pop(sig_t[0, s:e][None, :] ^ qwords[:, 0][:, None])
        for w in range(1, bw):
            ham += pop(sig_t[w, s:e][None, :] ^ qwords[:, w][:, None])
        key = bias[None, s:e] - ham * scale
        out[:, s // group : e // group] = key.reshape(q, (e - s) // group, group).amax(-1)
    return out


def hamming_packed_group_max_keys(
    sig_t: torch.Tensor,
    tie: torch.Tensor,
    qwords: torch.Tensor,
    *,
    num_perm: int,
    group: int,
    scale: int,
    word_bits: int = 32,
) -> torch.Tensor:
    """Per-group maxima of packed (P + 1 - hamming, tie) keys — kernel B3.

    Args:
        sig_t: ``(BW, C)`` int32 transposed packed signatures (the
            collision store's own words; no bitplanes). On the card it may
            be a view whose rows lie further apart than C words, as a block
            or live prefix ``words[:, s:e]`` of a wider store is: the kernel
            reads it in place (:func:`packed_words_stride`).
        tie: ``(C,)`` int32 tie keys (-1 dead), contiguous.
        qwords: ``(Q, BW)`` int32 query words.
        num_perm: signature bits P (the words hold at most P set bits).
        group: slots per group, a power of two dividing C (16, 32, 64 or
            128 for the CUDA kernel, which also needs BW <= 64).
        scale: ``key_scale(C)``; ``(P + 2) * scale`` must fit int32.
        word_bits: the low bits of each word that count (1..32); the store
            passes ``rows_per_band`` where a band is one word. The CUDA
            kernel multiplies ``packed_width(BW, word_bits)`` columns.

    Returns:
        ``(Q, C // group)`` int32 group-max keys, contiguous groups.
    """
    bw, c = sig_t.shape
    q = qwords.shape[0]
    _check("sig_t", sig_t, torch.int32, (bw, c))
    _check("tie", tie, torch.int32, (c,))
    _check("qwords", qwords, torch.int32, (q, bw))
    if group <= 0 or group & (group - 1) or c % group:
        raise ValueError(f"group must be a power of two dividing C={c}; got {group}")
    if (num_perm + 2) * scale >= 2**31:
        raise ValueError(
            f"(num_perm + 2) * scale = {(num_perm + 2) * scale} does not fit int32"
        )
    if not 1 <= word_bits <= 32:
        raise ValueError(f"word_bits must be in 1..32; got {word_bits}")
    dev = _device(sig_t, tie, qwords)
    if dev.type == "cpu":
        with span("lshrs.b3"):
            return hamming_packed_group_max_keys_ref(
                sig_t, tie, qwords, num_perm=num_perm, group=group, scale=scale,
                word_bits=word_bits,
            )
    if not (tie.is_contiguous() and qwords.is_contiguous()):
        raise ValueError("hamming_packed_group_max_keys: CUDA tie and qwords must be contiguous")
    ld = packed_words_stride(sig_t)
    if tie.data_ptr() % 16:
        raise ValueError("hamming_packed_group_max_keys: tie must be 16-byte aligned")
    if group not in (16, 32, 64, 128) or bw > 64:
        raise ValueError(
            f"the CUDA kernel needs group in (16, 32, 64, 128) and BW <= 64; "
            f"got group={group}, BW={bw}"
        )
    if q == 0:
        return torch.empty((0, c // group), dtype=torch.int32, device=dev)
    kp = packed_width(bw, word_bits)
    with span("lshrs.b3"):
        # The queries' +-1 operand (Q * K bytes) before the output: its
        # temporaries are gone before the (Q, C / group) keys exist.
        qop = packed_operand(qwords, word_bits=word_bits, width=kp)
        out = torch.empty((q, c // group), dtype=torch.int32, device=dev)
        _launch(
            "lshrs_hamming_packed_group_max", dev,
            sig_t.data_ptr(), tie.data_ptr(), qop.data_ptr(), out.data_ptr(),
            q, c, ld, bw, word_bits, kp, group, scale, num_perm,
        )
    hamming_packed_group_max_keys.launches += 1
    hamming_packed_group_max_keys.launches_by_shape[bw, word_bits] += 1
    return out


hamming_packed_group_max_keys.launches = 0
# The same launches, by (words BW, word_bits): the expansion a path reached.
hamming_packed_group_max_keys.launches_by_shape = collections.Counter()
