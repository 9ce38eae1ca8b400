"""Sign-bitpack: turn projected batches into packed per-band signature words.

A batch of vectors is hashed with one matmul ``(n, dim) @ (dim, num_perm)``;
this module handles the second half — thresholding at zero and packing the
resulting bits into little-endian 32-bit words, ``words_per_band =
ceil(rows_per_band / 32)`` per band, so signatures can be compared with a
handful of integer equality ops instead of byte-string hashing.

Bit layout (identical to the reference's ``packbits(bitorder="little")``
followed by little-endian word reads): global bit ``j`` belongs to band
``j // rows_per_band``, row ``j % rows_per_band``; within a band, row ``t``
lands in word ``t // 32`` at bit position ``t % 32``. Unused high bits of
the last word of a band are zero.

Word dtype on the torch side: ``int32`` holding the uint32 bit pattern.
CPU torch lacks ``>>`` and ``index_select`` for ``uint32``, so every
device-side word is an int32 bit-view; the host-side NumPy functions keep
``uint32`` and :func:`as_words` / :func:`words_to_numpy` convert at the
boundary (a reinterpretation, never a value change). Packing sums shifted
bits in int64 and narrows with an explicit 32-bit wrap
(:func:`_wrap_int32`), never a saturating cast.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_words",
    "words_to_numpy",
    "words_per_band",
    "bytes_per_band",
    "pack_bits_to_words",
    "pack_bits_to_words_np",
    "words_to_band_bytes",
    "band_bytes_to_words",
    "pack_bits_dense_np",
    "dense_to_words",
    "narrow_refine_r",
    "narrow_words_count",
    "pack_words_narrow",
    "popcount31",
    "popcount32",
]


def as_words(words, device) -> torch.Tensor:
    """Signature words (NumPy uint32/int32, or a torch int32/uint32 tensor)
    -> a contiguous int32 bit-view tensor on ``device``."""
    if isinstance(words, torch.Tensor):
        t = words
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        elif t.dtype != torch.int32:
            raise TypeError(f"signature words must be int32/uint32; got {t.dtype}")
    else:
        arr = np.asarray(words)
        if arr.dtype not in (np.uint32, np.int32):
            raise TypeError(f"signature words must be uint32; got {arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
    return t.to(device).contiguous()


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-view word tensor -> host ``uint32`` array (same bits)."""
    return words.detach().cpu().numpy().view(np.uint32)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 with the same low 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 bit-view word (SWAR; torch has no popcount).

    Widened to int64 first so every SWAR step is plain non-negative
    arithmetic on the 32-bit pattern.
    """
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def popcount31(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values (below 2**31), in int32: every
    SWAR step stays non-negative and below 2**31, so unlike
    :func:`popcount32` nothing is widened (half the bytes per step)."""
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    return (v + (v >> 16)) & 0x3F


def words_per_band(rows_per_band: int) -> int:
    """Number of 32-bit words needed to hold one band's bits."""
    return -(-rows_per_band // 32)


def narrow_refine_r(rows_per_band: int) -> int:
    """Bits per band in the NARROW refine-table packing, or 0 if n/a.

    The word-aligned store layout spends one word per band even when
    ``rows_per_band < 32``; the refine stage is gather-bound, so its
    table packs several bands per word when they fit evenly
    (``32 % rows_per_band == 0``) — at the flagship shape (r=16) that
    halves the refine gather's bytes. Returns ``rows_per_band`` when the
    narrow packing applies, else 0.
    """
    if 0 < rows_per_band < 32 and 32 % rows_per_band == 0:
        return rows_per_band
    return 0


def narrow_words_count(num_bands: int, rows_per_band: int) -> int:
    """Words per slot in the narrow refine packing."""
    bpw = 32 // rows_per_band
    return -(-num_bands // bpw)


def pack_words_narrow(
    words: torch.Tensor, *, num_bands: int, rows_per_band: int
) -> torch.Tensor:
    """Word-aligned signature words -> narrow refine words.

    Args:
        words: ``(n, num_bands)`` int32 — one word per band (the layout
            when ``rows_per_band < 32``), only the low ``rows_per_band``
            bits of each in use.
    Returns:
        ``(n, narrow_words_count(...))`` int32; band ``b`` occupies bits
        ``[(b % bpw) * r, ...)`` of word ``b // bpw`` (``bpw = 32 // r``).
        Unused high bits of a trailing partial word are zero.
    """
    r = rows_per_band
    bpw = 32 // r
    n = words.shape[0]
    nw = narrow_words_count(num_bands, r)
    w = (words & ((1 << r) - 1)).to(torch.int64)
    pad = nw * bpw - num_bands
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    shifts = torch.arange(bpw, dtype=torch.int64, device=words.device) * r
    return _wrap_int32((w.reshape(n, nw, bpw) << shifts).sum(-1))


def bytes_per_band(rows_per_band: int) -> int:
    """Number of bytes in one band's dense (wire) signature."""
    return -(-rows_per_band // 8)


def pack_bits_dense_np(
    bits: np.ndarray, *, num_bands: int, rows_per_band: int
) -> np.ndarray:
    """Sign bits -> dense wire signatures, ``(n, num_bands * ceil(r/8))`` u8.

    The minimal byte encoding of a signature (the reference's per-band
    ``packbits(little)`` bytes, concatenated). Used as the serving wire
    format: for ``r = 16`` this is 32 bytes per query instead of the 64
    bytes of the word layout. Decode on device with :func:`dense_to_words`.
    """
    n = bits.shape[0]
    if rows_per_band % 8 == 0:
        # Byte-aligned bands: the flat little-endian packing coincides
        # with the per-band layout (global bit j = band j//r, row j%r).
        return np.packbits(
            np.ascontiguousarray(bits).reshape(n, -1), axis=-1, bitorder="little"
        )
    banded = bits.reshape(n, num_bands, rows_per_band).astype(np.uint8)
    packed = np.packbits(banded, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed.reshape(n, -1))


def dense_to_words(
    dense: torch.Tensor, *, num_bands: int, rows_per_band: int
) -> torch.Tensor:
    """Dense wire signatures ``(n, num_bands * ceil(r/8))`` uint8 ->
    ``(n, num_bands * W)`` int32 words (inverse of
    :func:`pack_bits_dense_np`, into the store's word layout)."""
    n = dense.shape[0]
    w = words_per_band(rows_per_band)
    nb = bytes_per_band(rows_per_band)
    banded = dense.reshape(n, num_bands, nb).to(torch.int64)
    pad = w * 4 - nb
    if pad:
        banded = torch.nn.functional.pad(banded, (0, pad))
    shifts = torch.arange(4, dtype=torch.int64, device=dense.device) * 8
    words = (banded.reshape(n, num_bands, w, 4) << shifts).sum(-1)
    return _wrap_int32(words).reshape(n, num_bands * w)


def pack_bits_to_words(
    bits: torch.Tensor, *, num_bands: int, rows_per_band: int
) -> torch.Tensor:
    """Pack sign bits into per-band int32 words.

    Args:
        bits: ``(n, num_bands * rows_per_band)`` boolean (or 0/1) tensor of
            hyperplane signs for a batch of vectors.

    Returns:
        ``(n, num_bands * words_per_band)`` int32 tensor; band ``b`` owns
        the contiguous word slice ``[b * W, (b + 1) * W)``.
    """
    n = bits.shape[0]
    w = words_per_band(rows_per_band)
    banded = bits.reshape(n, num_bands, rows_per_band).to(torch.int64)
    pad = w * 32 - rows_per_band
    if pad:
        banded = torch.nn.functional.pad(banded, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (banded.reshape(n, num_bands, w, 32) << shifts).sum(-1)
    return _wrap_int32(words).reshape(n, num_bands * w)


def pack_bits_to_words_np(
    bits: np.ndarray, *, num_bands: int, rows_per_band: int
) -> np.ndarray:
    """NumPy twin of :func:`pack_bits_to_words` (host path), ``uint32``."""
    n = bits.shape[0]
    w = words_per_band(rows_per_band)
    banded = bits.reshape(n, num_bands, rows_per_band).astype(np.uint8)
    # packbits(little) then zero-pad each band's bytes to a whole word count.
    packed = np.packbits(banded, axis=-1, bitorder="little")  # (n, B, ceil(r/8))
    full = np.zeros((n, num_bands, w * 4), dtype=np.uint8)
    full[:, :, : packed.shape[-1]] = packed
    words = full.view("<u4").reshape(n, num_bands * w)
    return np.ascontiguousarray(words)


def words_to_band_bytes(
    words_row: np.ndarray, *, num_bands: int, rows_per_band: int
) -> tuple[bytes, ...]:
    """One signature row ``(num_bands * W,)`` -> per-band packed bytes.

    Truncates each band's little-endian word bytes to ``ceil(r / 8)`` so the
    result is identical to the reference's ``packbits(...).tobytes()``.
    """
    w = words_per_band(rows_per_band)
    nbytes = -(-rows_per_band // 8)
    raw = np.asarray(words_row, dtype="<u4").reshape(num_bands, w).tobytes()
    stride = w * 4
    return tuple(raw[b * stride : b * stride + nbytes] for b in range(num_bands))


def band_bytes_to_words(bands: tuple[bytes, ...], *, rows_per_band: int) -> np.ndarray:
    """Per-band packed bytes -> ``(num_bands * W,)`` uint32 word row."""
    w = words_per_band(rows_per_band)
    out = np.zeros((len(bands), w * 4), dtype=np.uint8)
    for i, band in enumerate(bands):
        buf = np.frombuffer(band, dtype=np.uint8)
        out[i, : buf.shape[0]] = buf
    return out.view("<u4").reshape(-1)
