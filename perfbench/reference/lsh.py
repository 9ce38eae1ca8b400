"""What a banded sign-bit LSH index answers, worked out plainly.

The hyperplanes are the gaussian family's seeded draw, a frozen copy of
``lshrs_tpu_torch/hash/hasher.py:238``; a vector's bits are the signs of
its projections, computed here in float64 (``precision="float64"``, the
truth) or in TF32 (``"tf32"``, the control: the nearest precision below
the float32 with TF32 off that the index states). Answers are the exact
top-k of every stored row by (band collisions desc, id asc), zero
collisions reported as id -1, or by (Hamming distance asc, id asc).

Imports NumPy and torch only: nothing of the program under test.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["answers", "hyperplanes", "mismatch", "sign_bits"]


def hyperplanes(seed: int, num_perm: int, dim: int) -> np.ndarray:
    """The ``(num_perm, dim)`` float32 hyperplanes of the gaussian family."""
    return np.random.default_rng(seed).standard_normal((num_perm, dim)).astype(np.float32)


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest (ties away
    from zero), as the tensor cores round their inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def sign_bits(x: torch.Tensor, planes: torch.Tensor, *, precision: str,
              block: int = 1 << 16) -> torch.Tensor:
    """``(n, P)`` bool: the signs of ``x @ planes.T``, in row blocks."""
    out = torch.empty((x.shape[0], planes.shape[0]), dtype=torch.bool, device=x.device)
    if precision == "float64":
        p = planes.double().T
    elif precision == "tf32":
        p = planes.float().T if x.is_cuda else _round_tf32(planes.float()).T
    else:
        raise ValueError(f"precision must be 'float64' or 'tf32', not {precision!r}")
    for s in range(0, x.shape[0], block):
        xb = x[s : s + block]
        if precision == "float64":
            coords = xb.double() @ p
        elif x.is_cuda:  # the card's TF32 tensor-core product
            with _tf32(True):
                coords = xb.float() @ p
        else:  # no TF32 unit on the CPU: its input rounding, float32 sums
            coords = _round_tf32(xb.float()) @ p
        out[s : s + block] = coords > 0
    return out


def _band_keys(bits: torch.Tensor, num_bands: int) -> torch.Tensor:
    r = bits.shape[1] // num_bands
    weights = 1 << torch.arange(r, dtype=torch.int64, device=bits.device)
    return (bits.reshape(bits.shape[0], num_bands, r).long() * weights).sum(-1)


def _collision_topk(qbits, dbits, *, num_bands: int, k: int, block: int) -> torch.Tensor:
    qk, dk = _band_keys(qbits, num_bands), _band_keys(dbits, num_bands)
    n = dk.shape[0]
    tie = n - 1 - torch.arange(n, dtype=torch.int64, device=dk.device)
    out = []
    for s in range(0, qk.shape[0], block):
        q = qk[s : s + block]
        counts = torch.zeros((q.shape[0], n), dtype=torch.int64, device=dk.device)
        for b in range(num_bands):
            counts += q[:, b, None] == dk[None, :, b]
        top = torch.topk(counts * n + tie, min(k, n), dim=1).values
        ids = n - 1 - top % n
        out.append(torch.where(top // n > 0, ids, -1))
    return torch.cat(out)


def _hamming_topk(qbits, dbits, *, k: int, block: int) -> torch.Tensor:
    p = dbits.shape[1]
    n = dbits.shape[0]
    d = dbits.float() * 2 - 1
    slot = torch.arange(n, dtype=torch.int64, device=d.device)
    out = []
    with _tf32(False):  # +-1 sums: exact in float32
        for s in range(0, qbits.shape[0], block):
            q = qbits[s : s + block].float() * 2 - 1
            dist = (p - (q @ d.T)).long() // 2
            top = torch.topk(dist * n + slot, min(k, n), dim=1, largest=False).values
            out.append(top % n)
    return torch.cat(out)


def answers(index: dict, data: np.ndarray, queries: np.ndarray, *, ranking: str,
            k: int, precision: str, device, block: int = 256) -> np.ndarray:
    """The ``(len(queries), k)`` ids an index of ``data`` (ids 0..n-1)
    answers for ``queries`` by ``ranking`` ("collision" or "hamming")."""
    planes = torch.from_numpy(hyperplanes(index["seed"], index["num_perm"], index["dim"]))
    planes = planes.to(device)
    dbits = sign_bits(torch.from_numpy(data).to(device), planes, precision=precision)
    qbits = sign_bits(torch.from_numpy(queries).to(device), planes, precision=precision)
    if ranking == "collision":
        ids = _collision_topk(qbits, dbits, num_bands=index["num_bands"], k=k, block=block)
    elif ranking == "hamming":
        ids = _hamming_topk(qbits, dbits, k=k, block=block)
    else:
        raise ValueError(f"ranking must be 'collision' or 'hamming', not {ranking!r}")
    return ids.cpu().numpy()


def mismatch(got: np.ndarray, want: np.ndarray) -> float:
    """Share of queries whose ``k`` ids differ from the reference's in any
    position."""
    if got.shape != want.shape:
        return 1.0
    return float(np.mean(np.any(got != want, axis=1)))
