"""Cross-polytope LSH — the strongest known hash family for angular distance.

Sign-of-hyperplane hashing makes each band ``r`` independent sign bits,
and two vectors collide when all ``r`` signs agree. Cross-polytope
hashing (Andoni, Indyk, Laarhoven, Razenshteyn & Schmidt, NeurIPS 2015 —
the FALCONN family) replaces a band's ``r`` hyperplanes with ONE
pseudo-random rotation: rotate the vector, find the coordinate of largest
magnitude among the first ``cp_dims`` rotated coordinates, and emit the
*signed axis index* as the band's bucket symbol —

    symbol = 2 * argmax_i |y_i|  +  (y_argmax < 0),   y = R x

i.e. the nearest vertex of the cross-polytope ``{±e_i}``. With
``cp_dims = 2^(r-1)`` a band has exactly ``2^r`` buckets — the same bucket
count (and the same stored key width) as an ``r``-bit hyperplane band — but
a strictly better collision-probability profile: cross-polytope is
*asymptotically optimal* for angular LSH (exponent ``rho = 1/(2c^2 - 1)``)
while hyperplane hashing is not.

Realisation
-----------

- The rotation is the same pseudo-random FWHT sandwich as the structured
  sign family (`lshrs_tpu_torch.hash.fwht`): ``y = H D3 H D2 H D1 x_pad``
  with seeded ±1 diagonals — but one INDEPENDENT rotation block per band
  (``diags`` has shape ``(num_bands, 3, dpad)``), since each band must be
  an independent hash. Host (native C / NumPy) and device (PyTorch) paths
  are bit-identical by the FWHT association-order contract; ``argmax``
  returns the first maximum in NumPy and PyTorch alike, and the probe
  ranking is a *stable* argsort on both sides, so host- and device-hashed
  signatures agree bit-for-bit, exact magnitude ties included.
- A band's symbol is encoded as its ``r``-bit little-endian binary
  expansion, so the *entire* downstream engine — word packing
  (`lshrs_tpu_torch.ops.bitpack`), dense wire signatures, narrow refine
  tables, the collision scan on kernel B1 (band-word equality IS symbol
  equality), the probe-major multi-probe wire and the serving closures —
  works unchanged. Only *bit-semantic* estimators (Hamming ranking) are
  inapplicable and rejected at construction.
- Multi-probe: probe ``t`` emits the ``t``-th largest-|coordinate| signed
  axis per band — the natural cross-polytope probing sequence (the
  nearest alternative polytope vertices), mirroring the sign family's
  lowest-margin bit flips. Probe symbols within a band are pairwise
  distinct by construction (distinct argmax indices), which is what keeps
  any-probe collision counts ``<= num_bands``.
"""

from __future__ import annotations

import numpy as np

import torch

from lshrs_tpu_torch.hash.fwht import (
    MAX_DPAD,
    next_pow2,
    slice_rows,
    structured_coords_np,
    structured_coords_torch,
)

__all__ = [
    "cp_dims_for",
    "validate_cp_geometry",
    "cp_diags",
    "cp_bits_np",
    "cp_bits_torch",
    "cp_probe_bits_np",
    "cp_probe_bits_torch",
    "max_cp_probes",
]


def cp_dims_for(rows_per_band: int) -> int:
    """Rotated coordinates a band's argmax ranges over: ``2^(r-1)``.

    The signed axis index then spans ``2 * cp_dims = 2^r`` symbols —
    exactly the bucket count of an ``r``-bit hyperplane band, so
    ``rows_per_band`` keeps its meaning as "key bits per band" and every
    signature-width / memory computation holds unchanged.
    """
    return 1 << (rows_per_band - 1)


def max_cp_probes(rows_per_band: int) -> int:
    """Distinct probe symbols available per band (= ``cp_dims``)."""
    return cp_dims_for(rows_per_band)


def validate_cp_geometry(dim: int, rows_per_band: int) -> None:
    """Raise unless ``2^(r-1) <= next_pow2(dim)`` (and ``r >= 2``)."""
    if rows_per_band < 2:
        raise ValueError(
            "the cross-polytope family needs rows_per_band >= 2 "
            "(2^r bucket symbols per band)"
        )
    dpad = next_pow2(dim)
    if dpad > MAX_DPAD:
        raise ValueError(
            f"cross-polytope hash supports dim <= {MAX_DPAD}; got dim={dim}"
        )
    cp_d = cp_dims_for(rows_per_band)
    if cp_d > dpad:
        raise ValueError(
            f"rows_per_band={rows_per_band} needs cp_dims=2^(r-1)={cp_d} "
            f"rotated coordinates, but dim={dim} only provides "
            f"next_pow2(dim)={dpad}; reduce rows_per_band to "
            f"<= {int(np.log2(dpad)) + 1}"
        )


def cp_diags(seed: int, *, dim: int, num_bands: int) -> np.ndarray:
    """Seeded ±1 diagonals, ``(num_bands, 3, dpad)`` float32.

    One independent FWHT rotation block PER BAND (the structured sign
    family reuses one rotation across ``dpad`` bits; a cross-polytope band
    consumes a whole rotation, so bands need independent blocks).
    """
    dpad = next_pow2(dim)
    if dpad > MAX_DPAD:
        raise ValueError(
            f"cross-polytope hash supports dim <= {MAX_DPAD}; got dim={dim}"
        )
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(num_bands, 3, dpad), dtype=np.int8)
    return bits.astype(np.float32) * 2.0 - 1.0


def _symbols_to_bits(symbols, rows_per_band: int, xp):
    """Signed axis symbols ``(..., B)`` -> little-endian bits
    ``(..., B * r)`` — the encoding under which band-word equality is
    symbol equality and all bitpack machinery applies verbatim. Symbols
    are int32 (``< 2^r``), for NumPy (``xp=np``) and PyTorch
    (``xp=torch``: the CPU has no ``>>`` for unsigned 32-bit) alike."""
    if xp is torch:
        shifts = torch.arange(rows_per_band, dtype=symbols.dtype, device=symbols.device)
    else:
        shifts = np.arange(rows_per_band, dtype=symbols.dtype)
    bits = (symbols[..., None] >> shifts) & 1
    return (bits != 0).reshape(*symbols.shape[:-1], -1)


def _cp_symbols_np(
    x: np.ndarray, diags: np.ndarray, *, num_bands: int, rows_per_band: int
) -> np.ndarray:
    """Host symbols ``(n, num_bands)`` int32 via the native/NumPy FWHT."""
    n = x.shape[0]
    dpad = diags.shape[2]
    cp_d = cp_dims_for(rows_per_band)
    # All bands' full rotations in one call: (n, num_bands * dpad). This is
    # exactly the structured family's multi-block path, so the native C
    # FWHT kernel (`lshrs_tpu_torch/native/fwht.c`) serves cross-polytope too.
    coords = structured_coords_np(x, diags, num_bands * dpad)
    y = coords.reshape(n, num_bands, dpad)[:, :, :cp_d]
    i = np.argmax(np.abs(y), axis=2).astype(np.int32)  # first max on ties
    vmax = np.take_along_axis(y, i[:, :, None], axis=2)[:, :, 0]
    return 2 * i + (vmax < 0)


def cp_bits_np(
    x: np.ndarray, diags: np.ndarray, *, num_bands: int, rows_per_band: int
) -> np.ndarray:
    """Host signature bits ``(n, num_bands * rows_per_band)`` bool."""
    sym = _cp_symbols_np(
        x, diags, num_bands=num_bands, rows_per_band=rows_per_band
    )
    return _symbols_to_bits(sym, rows_per_band, np)


def _cp_band_coords_torch(x, diags, band: int, cp_d: int) -> torch.Tensor:
    """Band ``band``'s first ``cp_d`` rotated coordinates, ``(n, cp_d)``:
    the same block of the multi-block structured rotation the host path
    computes in one call, so the floats are bit-identical."""
    dpad = diags.shape[2]
    return structured_coords_torch(x, diags[band : band + 1], dpad)[:, :cp_d]


def cp_bits_torch(
    x: torch.Tensor, diags: torch.Tensor, *, num_bands: int, rows_per_band: int
) -> torch.Tensor:
    """Device twin of :func:`cp_bits_np` — bit-identical by the FWHT
    association-order contract plus matching argmax tie rules (NumPy and
    PyTorch, on the CPU and on CUDA, return the first maximum).

    One rotation per band: the host path's ``(n, num_bands * dpad)``
    coordinate block would be 128 KiB per vector at 32 bands x 1024, so
    this twin rotates band by band and keeps only each band's symbol, in
    slices of `lshrs_tpu_torch.hash.fwht.slice_rows` rows (65,536 at
    dpad = 1024): the temporaries stay near 1 GiB whatever ``n``.
    """
    n = x.shape[0]
    step = slice_rows(diags.shape[2])
    if n > step:
        return torch.cat([
            cp_bits_torch(
                x[i : i + step], diags, num_bands=num_bands, rows_per_band=rows_per_band
            )
            for i in range(0, n, step)
        ])
    cp_d = cp_dims_for(rows_per_band)
    syms = []
    for b in range(num_bands):
        y = _cp_band_coords_torch(x, diags, b, cp_d)
        i = torch.argmax(y.abs(), dim=1)  # first max on ties
        vmax = y.gather(1, i[:, None])[:, 0]
        syms.append((2 * i + (vmax < 0)).to(torch.int32))
    return _symbols_to_bits(torch.stack(syms, dim=1), rows_per_band, torch)


def cp_probe_bits_np(
    x: np.ndarray,
    diags: np.ndarray,
    *,
    num_bands: int,
    rows_per_band: int,
    n_probes: int,
) -> np.ndarray:
    """Host probe bits ``(n, n_probes, num_bands * rows_per_band)`` bool.

    Probe ``t`` is the ``t``-th largest-|coordinate| signed axis of every
    band (probe 0 = the plain signature). Ties order by ascending index
    (stable argsort of ``-|y|``), on the host and the device alike.
    """
    if n_probes < 1 or n_probes > max_cp_probes(rows_per_band):
        raise ValueError(
            "n_probes must be in [1, cp_dims] "
            f"(= {max_cp_probes(rows_per_band)}); received {n_probes}"
        )
    n = x.shape[0]
    dpad = diags.shape[2]
    cp_d = cp_dims_for(rows_per_band)
    coords = structured_coords_np(x, diags, num_bands * dpad)
    y = coords.reshape(n, num_bands, dpad)[:, :, :cp_d]
    order = np.argsort(-np.abs(y), axis=2, kind="stable")[:, :, :n_probes]
    vals = np.take_along_axis(y, order, axis=2)
    sym = (2 * order + (vals < 0)).astype(np.int32)  # (n, B, T)
    bits = _symbols_to_bits(
        np.moveaxis(sym, 2, 1), rows_per_band, np
    )  # (n, T, B * r)
    return bits


def cp_probe_bits_torch(
    x: torch.Tensor,
    diags: torch.Tensor,
    *,
    num_bands: int,
    rows_per_band: int,
    n_probes: int,
) -> torch.Tensor:
    """Device twin of :func:`cp_probe_bits_np`: a STABLE descending
    argsort of ``|y|`` per band, the host's tie rule (``torch.topk`` keeps
    no order among equal magnitudes). Sliced by rows like
    :func:`cp_bits_torch`."""
    if n_probes < 1 or n_probes > max_cp_probes(rows_per_band):
        raise ValueError(
            "n_probes must be in [1, cp_dims] "
            f"(= {max_cp_probes(rows_per_band)}); received {n_probes}"
        )
    n = x.shape[0]
    step = slice_rows(diags.shape[2])
    if n > step:
        return torch.cat([
            cp_probe_bits_torch(
                x[i : i + step], diags, num_bands=num_bands,
                rows_per_band=rows_per_band, n_probes=n_probes,
            )
            for i in range(0, n, step)
        ])
    cp_d = cp_dims_for(rows_per_band)
    syms = []
    for b in range(num_bands):
        y = _cp_band_coords_torch(x, diags, b, cp_d)
        order = torch.argsort(-y.abs(), dim=1, stable=True)[:, :n_probes]
        vals = y.gather(1, order)
        syms.append((2 * order + (vals < 0)).to(torch.int32))  # (n, T)
    sym = torch.stack(syms, dim=2)  # (n, T, B)
    return _symbols_to_bits(sym, rows_per_band, torch)
