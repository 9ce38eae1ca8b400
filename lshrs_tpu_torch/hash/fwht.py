"""Structured (Fast Walsh-Hadamard) LSH projections.

Hyperplane LSH multiplies every vector by a dense ``(num_perm, dim)``
Gaussian matrix. The structured family replaces the Gaussian matrix with
pseudo-random rotations

    y = H D3 H D2 H D1 x_pad

(``D_i`` seeded random +-1 diagonals, ``H`` the unnormalised Walsh-Hadamard
transform on ``dpad = next_pow2(dim)`` coordinates); hash bits are the signs
of the first ``num_perm`` rotated coordinates (additional independent
rotation blocks cover ``num_perm > dpad``). Three HD layers are the
standard recipe (FALCONN-style pseudo-random rotations; Andoni et al. 2015)
for making the rotation behave like a uniformly random one — for any fixed
query/corpus pair the per-bit collision probability matches the Gaussian
family's ``1 - angle/pi`` and banded AND-OR amplification applies unchanged.
Cost: ``3 dpad log2(dpad)`` adds + ``3 dpad`` multiplies per vector — ~13x
fewer flops than the sgemm at dim=768, num_perm=256, and L1-resident in
the C implementation (`lshrs_tpu_torch/native/fwht.c`).

Bit-parity contract: the NumPy, PyTorch and C implementations perform the
butterfly passes in the *same* order (h = 1, 2, ..., dpad/2), so their
float32 outputs — and therefore the hash bits — are bit-identical on every
backend, the reference package's NumPy, JAX and C paths included. Addition
order is the only degree of freedom in FWHT; fixing it makes the transform
deterministic across hosts and devices, which is what lets one store accept
host- and device-hashed queries interchangeably (stronger than the Gaussian
family, where a host sgemm and a device matmul round differently and one
hash path per store is required). Multiplying by a +-1 diagonal is exact,
so a fused multiply-add cannot change a bit either.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "next_pow2",
    "structured_diags",
    "structured_coords_np",
    "structured_coords_torch",
    "fwht_np",
    "fwht_torch",
    "slice_rows",
    "MAX_DPAD",
    "SLICE_BYTES",
]

MAX_DPAD = 8192  # keep one vector's buffer L1/L2-resident in the C path
# Bytes of ONE (rows, dpad) float32 temporary of the PyTorch FWHT. A
# butterfly pass holds about four of them (its input, a + b, a - b and the
# stacked result), so hashing in row slices of this size keeps the device
# temporaries near 1 GiB: 65,536 rows per slice at dpad = 1024.
SLICE_BYTES = 1 << 28


def slice_rows(dpad: int) -> int:
    """Rows per slice of the PyTorch FWHT paths (see `SLICE_BYTES`)."""
    return max(1, SLICE_BYTES // (4 * dpad))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 2)."""
    return 1 << max(1, (int(n) - 1).bit_length())


def structured_diags(seed: int, *, dim: int, num_perm: int) -> np.ndarray:
    """Seeded +-1 diagonals, ``(nblocks, 3, dpad)`` float32.

    ``dpad = next_pow2(dim)``; ``nblocks = ceil(num_perm / dpad)``
    independent rotation blocks cover signatures wider than one rotation.
    """
    dpad = next_pow2(dim)
    if dpad > MAX_DPAD:
        raise ValueError(
            f"structured hash supports dim <= {MAX_DPAD}; got dim={dim}"
        )
    nblocks = -(-num_perm // dpad)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(nblocks, 3, dpad), dtype=np.int8)
    return (bits.astype(np.float32) * 2.0 - 1.0)


def fwht_np(y: np.ndarray) -> np.ndarray:
    """Unnormalised FWHT over the last axis of ``(n, d)``, d a power of 2.

    Pass order h = 1, 2, ..., d/2; within a pass pair (t, t+h) maps to
    (a+b, a-b).  This order is normative — see module docstring.
    """
    n, d = y.shape
    h = 1
    while h < d:
        y3 = y.reshape(n, d // (2 * h), 2, h)
        a = y3[:, :, 0, :]
        b = y3[:, :, 1, :]
        y = np.stack((a + b, a - b), axis=2).reshape(n, d)
        h *= 2
    return y


def fwht_torch(y: torch.Tensor) -> torch.Tensor:
    """PyTorch twin of :func:`fwht_np` — identical pass/association order
    (plain elementwise adds on the tensor's device; never a matmul with a
    Hadamard matrix, which would reorder the sums)."""
    n, d = y.shape
    h = 1
    while h < d:
        y3 = y.reshape(n, d // (2 * h), 2, h)
        a = y3[:, :, 0, :]
        b = y3[:, :, 1, :]
        y = torch.stack((a + b, a - b), dim=2).reshape(n, d)
        h *= 2
    return y


def _structured_coords(x, diags, num_perm: int, fwht, pad, cat):
    n, dim = x.shape
    nblocks, _, dpad = diags.shape
    outs = []
    produced = 0
    for blk in range(nblocks):
        if produced >= num_perm:
            break
        z = x * diags[blk, 0, :dim][None, :]
        if dpad != dim:
            z = pad(z, dpad - dim)
        z = fwht(z)
        z = fwht(z * diags[blk, 1][None, :])
        z = fwht(z * diags[blk, 2][None, :])
        take = min(num_perm - produced, dpad)
        outs.append(z[:, :take])
        produced += take
    return cat(outs) if len(outs) > 1 else outs[0]


def structured_coords_np(
    x: np.ndarray, diags: np.ndarray, num_perm: int
) -> np.ndarray:
    """Rotated coordinates ``(n, num_perm)`` float32 — C path when the
    native library loads (bit-identical, ~L1-resident), NumPy otherwise."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, dim = x.shape
    nblocks, _, dpad = diags.shape
    from lshrs_tpu_torch.native.build import load_fwht_library

    lib = load_fwht_library()
    if lib is not None:
        out = np.empty((n, num_perm), dtype=np.float32)
        d = np.ascontiguousarray(diags, dtype=np.float32)
        rc = lib.fwht_structured(
            x.ctypes.data, n, dim, d.ctypes.data, nblocks, dpad, num_perm,
            out.ctypes.data,
        )
        if rc == 0:
            return out
    return _structured_coords_numpy(x, diags, num_perm)


def _structured_coords_numpy(
    x: np.ndarray, diags: np.ndarray, num_perm: int
) -> np.ndarray:
    """The NumPy formulation of :func:`structured_coords_np`, whether or
    not the C library loads (the oracle the C path is held against)."""
    return _structured_coords(
        np.asarray(x, dtype=np.float32), diags, num_perm, fwht_np,
        lambda z, extra: np.pad(z, ((0, 0), (0, extra))),
        lambda outs: np.concatenate(outs, axis=1),
    )


def structured_coords_torch(
    x: torch.Tensor, diags: torch.Tensor, num_perm: int
) -> torch.Tensor:
    """PyTorch twin of :func:`structured_coords_np` (same association
    order), on the device of ``x``; ``diags`` is the ``(nblocks, 3, dpad)``
    float32 diagonal tensor on that device.

    Temporaries: each of the ``3 * log2(dpad)`` butterfly passes makes a
    new ``(n, dpad)`` float32 tensor per block, and the result holds
    ``num_perm`` columns — callers hash in slices of :func:`slice_rows`
    rows.
    """
    return _structured_coords(
        x, diags, num_perm, fwht_torch,
        lambda z, extra: torch.nn.functional.pad(z, (0, extra)),
        lambda outs: torch.cat(outs, dim=1),
    )
