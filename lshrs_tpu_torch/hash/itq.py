"""ITQ (iterative quantization) learned-rotation hash fitting.

Seeded random hyperplanes are data-oblivious by design. With a sample of
the indexed distribution one can do better: fit the hyperplanes to it, so
the binary codes preserve more of the neighborhood structure per bit.
Host-only NumPy, the reference package's fit line for line (`LSHRS.retrain`
/ `rehash`, which rebuild a store's signatures from a fitted matrix, are
not part of this package yet: ROADMAP Queue A).

Method (Gong & Lazebnik's iterative quantization). The HASH stays
LINEAR — ``bit = sign(x . w)`` with no offset — so every existing
kernel, wire format and serving closure works unchanged; only the FIT
is centered:

1. l2-normalize the sample rows (hash bits are scale-invariant; the fit
   should see the directions the cosine sees), then DEFLATE the mean
   direction: every fitted hyperplane is constrained exactly orthogonal
   to the sample mean. This is what makes an offset-free hash workable
   on real embeddings, which concentrate in a cone around their mean:
   a hyperplane through the origin splits the cone only if its normal
   is orthogonal to the cone axis to within the cone's width (measured
   here: in-cone spread ~0.015 vs |mean . w| ~0.1 for unconstrained
   centered PCA directions — bits come out CONSTANT, bias ~1.0, zero
   information; uncentered ITQ is worse still, its objective actively
   prefers the constant bits). The mean direction carries no ranking
   information among the points of the cone, so deflating it costs one
   dimension and no discrimination.
2. PCA: top-``k`` eigenvectors ``W`` of the deflated scatter matrix
   (``k = min(num_perm, dim - 1)``) — the subspace holding the sample's
   variance about its axis.
3. Alternate (a) ``B = sign(V R)`` and (b) the orthogonal Procrustes
   solution ``R = argmax tr(R^T V^T B)`` so the rotated coordinates
   ``V R`` are as close to their own signs as an orthogonal ``R``
   allows — bits become balanced, de-correlated carriers of the
   sample's variance instead of arbitrary slices of it.
4. The learned hyperplanes are ``P = (W R)^T``; if ``num_perm > dim``
   the remaining rows are seeded Gaussian draws (a rotation cannot
   manufacture more than ``dim`` independent directions — documented,
   counted in the returned info).

The result plugs in as ``hash_family="learned"``: identical matmul +
bitpack machinery as the gaussian family (one matmul per batch,
multi-probe margins, asymmetric coordinates, the fused build program),
only the matrix differs. Collision counting, tie-breaking and rerank
exactness are unaffected — the hash family changes *which* vectors
collide, never how honestly they are counted.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fit_itq_projection", "itq_fit_info"]


def _validated_sample(sample: np.ndarray) -> np.ndarray:
    x = np.asarray(sample, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError("sample must be a 2D array of shape (n, dim)")
    if x.shape[0] < 2:
        raise ValueError("sample must contain at least 2 vectors")
    norms = np.linalg.norm(x, axis=1)
    keep = norms > 0
    if not keep.any():
        raise ValueError("sample contains only zero vectors")
    return x[keep] / norms[keep, None]


def fit_itq_projection(
    sample: np.ndarray,
    num_perm: int,
    *,
    iters: int = 64,
    seed: int = 42,
    return_info: bool = False,
):
    """Fit a ``(num_perm, dim)`` learned projection matrix to a sample.

    Args:
        sample: ``(n, dim)`` float32 representative vectors (zero rows are
            dropped; rows are l2-normalized before the fit).
        num_perm: total hash bits; rows beyond ``dim`` fall back to seeded
            Gaussian hyperplanes (see module docstring).
        iters: ITQ alternation count (the objective plateaus fast;
            50-100 is the standard operating range).
        seed: seeds the rotation init and any Gaussian padding rows.
        return_info: also return a diagnostics dict (see `itq_fit_info`).

    Returns:
        ``(num_perm, dim)`` float32 matrix, rows are the hyperplanes —
        the exact layout `LSHHasher` stores, so
        ``LSHHasher(..., hash_family="learned", projection=P)`` (or the
        ``projections`` setter's per-band views) accepts it directly.
    """
    if num_perm <= 0:
        raise ValueError("num_perm must be > 0")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    x = _validated_sample(sample)
    n, dim = x.shape
    rng = np.random.default_rng(seed)

    # -- mean deflation + PCA (see the module docstring) ---------------------
    mu = x.mean(axis=0)
    mu_norm = float(np.linalg.norm(mu))
    if mu_norm > 1e-6 and dim > 1:
        u = (mu / mu_norm).astype(np.float32)
        xd = x - np.outer(x @ u, u)  # exact projection onto u-perp
        k = min(num_perm, dim - 1)
    else:
        u = None
        xd = x - mu[None, :]
        k = min(num_perm, dim)
    gram = (xd.T @ xd).astype(np.float64)  # (dim, dim); f64 keeps eigh stable
    evals, evecs = np.linalg.eigh(gram)  # ascending
    w = evecs[:, ::-1][:, :k].astype(np.float32)  # (dim, k)
    if u is not None:
        # numerically enforce the deflation constraint on the basis
        w = w - np.outer(u, u @ w)
        w /= np.maximum(np.linalg.norm(w, axis=0, keepdims=True), 1e-30)
    v = xd @ w  # (n, k) deflated PCA coordinates

    # -- ITQ alternation ------------------------------------------------------
    q0, _ = np.linalg.qr(rng.standard_normal((k, k)).astype(np.float32))
    r = q0.astype(np.float32)
    for _ in range(iters):
        b = np.where(v @ r >= 0, 1.0, -1.0).astype(np.float32)
        # orthogonal Procrustes: maximize tr(R^T V^T B). (Keep the SVD
        # factors off `u`: that name is the deflation direction, read
        # again below by the info dict.)
        lu, _, vt = np.linalg.svd((v.T @ b).astype(np.float64))
        r = (lu @ vt).astype(np.float32)

    proj = (w @ r).T  # (k, dim): learned hyperplanes
    if num_perm > k:
        pad = rng.standard_normal((num_perm - k, dim)).astype(np.float32)
        proj = np.concatenate([proj, pad], axis=0)

    if not return_info:
        return proj
    coords = x @ proj.T  # (n, num_perm)
    bits = coords > 0
    info = {
        "sample_rows": int(n),
        "fitted_bits": int(k),
        "padded_bits": int(num_perm - k),
        "deflated_mean": u is not None,
        "mean_norm": mu_norm,
        # mean |per-bit bias|: 0 = perfectly balanced bits, 1 = constant
        "bit_bias": float(np.abs(bits.mean(axis=0) * 2.0 - 1.0).mean()),
        # ITQ objective, normalized: mean |coord| along its own sign
        # (higher = codes carry more of the sample's energy)
        "quantization_alignment": float(
            np.abs(coords[:, :k]).mean() if k else 0.0
        ),
        "top_eigenvalue_share": float(evals[-1] / max(evals.sum(), 1e-30)),
    }
    return proj, info


def itq_fit_info(sample: np.ndarray, proj: np.ndarray) -> dict:
    """Diagnostics of an existing projection against a sample.

    Returns the same ``bit_bias`` / ``quantization_alignment`` metrics as
    ``fit_itq_projection(..., return_info=True)`` computes for its own
    output — useful for comparing a learned matrix against the seeded
    gaussian one on the caller's data.
    """
    x = _validated_sample(sample)
    p = np.asarray(proj, dtype=np.float32)
    # row-normalize so alignment is comparable across families (gaussian
    # rows have norm ~sqrt(dim); learned rows are unit by construction)
    p = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-30)
    coords = x @ p.T
    bits = coords > 0
    return {
        "bit_bias": float(np.abs(bits.mean(axis=0) * 2.0 - 1.0).mean()),
        "quantization_alignment": float(np.abs(coords).mean()),
    }
