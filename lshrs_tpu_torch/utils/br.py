"""Band/row auto-tuning from LSH S-curve probability theory.

Given ``num_perm`` total hash bits split into ``b`` bands of ``r`` rows
(``b * r == num_perm``), the probability that two items with similarity
``s`` collide in at least one band is the classic S-curve

    P(s) = 1 - (1 - s**r) ** b

The similarity at which P crosses ~0.5 is approximately ``(1/b) ** (1/r)``.
This module selects ``(b, r)`` to hit a target threshold while minimising
the sum of false-positive and false-negative probability mass, mirroring the
capability of the reference tuner (upstream `lshrs/utils/br.py`):

- ``compute_lsh_threshold`` — closed-form threshold estimate.
- ``compute_collision_probability`` — the S-curve itself.
- ``compute_false_rates`` — FP/FN mass via numerical integration.
- ``find_optimal_br`` — exhaustive factorization search within a threshold
  tolerance, scored by FP + FN.
- ``get_optimal_config`` — three tiers: precomputed table -> search ->
  square-root heuristic fallback.
- ``PRECOMPUTED_CONFIGS`` — table for num_perm in {4096..65536}; unlike the
  reference (which ships a hand-recorded table), entries here are *computed
  on first access* by the same optimizer and cached, so the table can never
  drift from the search.

Everything here is pure host-side math (it runs once at index construction),
so NumPy is the right tool; no device code is involved.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np

try:  # SciPy gives adaptive quadrature; fall back to composite Simpson.
    from scipy.integrate import quad as _scipy_quad
except ImportError:  # pragma: no cover - exercised only without scipy
    _scipy_quad = None

__all__ = [
    "PRECOMPUTED_CONFIGS",
    "compute_lsh_threshold",
    "compute_collision_probability",
    "compute_false_rates",
    "find_optimal_br",
    "get_optimal_config",
    "print_config_analysis",
]

# num_perm values and target thresholds for which configurations are
# precomputed (lazily, cached). Chosen to cover common production sizes.
_PRECOMPUTED_NUM_PERMS = (4096, 8192, 16384, 32768, 65536)
_PRECOMPUTED_THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95)

# How close a tabulated threshold must be to the requested one for the
# precomputed tier to be used (same ±0.05 window as the search tolerance).
_THRESHOLD_MATCH_TOL = 0.05


def compute_lsh_threshold(b: int, r: int) -> float:
    """Approximate similarity threshold of a (b, r) banding scheme.

    The point where the S-curve ``1 - (1 - s**r)**b`` crosses ~0.5,
    using the standard approximation ``t = (1/b) ** (1/r)``.
    """
    return (1.0 / b) ** (1.0 / r)


def compute_collision_probability(similarity: float, b: int, r: int) -> float:
    """Probability that two items of given similarity share >= 1 band.

    ``s**r`` is the chance all r rows of one band agree;
    ``(1 - s**r)**b`` the chance no band agrees.
    """
    return 1.0 - (1.0 - similarity**r) ** b


def _integrate(fn, lo: float, hi: float) -> float:
    """Integrate a smooth scalar function on [lo, hi].

    Uses SciPy adaptive quadrature when available (matches the reference's
    numerical behaviour); otherwise composite Simpson on a dense grid. The
    integrands are S-curves: smooth, monotone, with one sharp transition, so
    a dense fixed grid is accurate to well below the tolerances that matter
    for ranking configurations.
    """
    if hi <= lo:
        return 0.0
    if _scipy_quad is not None:
        val, _ = _scipy_quad(fn, lo, hi, limit=100)
        return float(val)
    # Composite Simpson fallback: 4097 points resolves transitions of width
    # ~1e-3 on [0, 1]; S-curve transition width is ~t/(b*r) at worst.
    n = 4096
    xs = np.linspace(lo, hi, n + 1)
    ys = np.asarray([fn(x) for x in xs], dtype=np.float64)
    h = (hi - lo) / n
    return float(h / 3.0 * (ys[0] + ys[-1] + 4.0 * ys[1:-1:2].sum() + 2.0 * ys[2:-1:2].sum()))


def compute_false_rates(b: int, r: int, threshold: float) -> tuple[float, float]:
    """False-positive / false-negative probability mass for (b, r).

    Assuming similarities distributed on [0, 1]:
      FP mass = integral of P(s) below the threshold (dissimilar items caught),
      FN mass = integral of 1 - P(s) above it (similar items missed).
    Returned unnormalised (raw integrals), matching the reference semantics
    (upstream `lshrs/utils/br.py`).
    """

    def p_collide(s: float) -> float:
        return 1.0 - (1.0 - s**r) ** b

    def p_miss(s: float) -> float:
        return (1.0 - s**r) ** b

    fp = _integrate(p_collide, 0.0, threshold)
    fn = _integrate(p_miss, threshold, 1.0)
    return fp, fn


def find_optimal_br(
    num_perm: int, target_threshold: float, tolerance: float = 0.05
) -> Optional[tuple[int, int]]:
    """Search all factorizations b*r == num_perm for the best config.

    A factorization qualifies when its estimated threshold is within
    ``tolerance`` of the target; qualifying configs are scored by
    FP + FN mass and the minimum wins. Returns None when no factorization
    lands inside the tolerance window (e.g. prime num_perm or an extreme
    target).
    """
    best: Optional[tuple[int, int]] = None
    best_score = math.inf
    seen: set[tuple[int, int]] = set()
    # Enumerate every divisor pair once: d <= sqrt(num_perm) paired both ways.
    for d in range(1, int(math.isqrt(num_perm)) + 1):
        if num_perm % d:
            continue
        for b, r in ((num_perm // d, d), (d, num_perm // d)):
            if (b, r) in seen:
                continue
            seen.add((b, r))
            if abs(compute_lsh_threshold(b, r) - target_threshold) > tolerance:
                continue
            fp, fn = compute_false_rates(b, r, target_threshold)
            score = fp + fn
            if score < best_score:
                best_score = score
                best = (b, r)
    return best


@lru_cache(maxsize=None)
def _precomputed_entry(num_perm: int, threshold: float) -> Optional[tuple[int, int]]:
    """Compute-and-cache one precomputed-table cell via the optimizer."""
    return find_optimal_br(num_perm, threshold)


class _LazyConfigTable(dict):
    """Dict-like precomputed table whose cells are computed on first access.

    Behaves as ``{num_perm: {threshold: (b, r)}}`` for the supported
    num_perm values; thresholds with no in-tolerance factorization are
    omitted from their row.
    """

    def __contains__(self, key) -> bool:  # type: ignore[override]
        return key in _PRECOMPUTED_NUM_PERMS

    def __getitem__(self, num_perm: int) -> dict[float, tuple[int, int]]:
        if num_perm not in _PRECOMPUTED_NUM_PERMS:
            raise KeyError(num_perm)
        row = {}
        for t in _PRECOMPUTED_THRESHOLDS:
            cfg = _precomputed_entry(num_perm, t)
            if cfg is not None:
                row[t] = cfg
        return row

    def keys(self):  # type: ignore[override]
        return iter(_PRECOMPUTED_NUM_PERMS)


PRECOMPUTED_CONFIGS = _LazyConfigTable()


def get_optimal_config(num_perm: int, target_threshold: float = 0.5) -> tuple[int, int]:
    """Pick (num_bands, rows_per_band) for a hash budget and target threshold.

    Three tiers, mirroring the reference behaviour
    (upstream `lshrs/utils/br.py`):
      1. precomputed table lookup when the nearest tabulated threshold is
         within ±0.05 of the target,
      2. full factorization search,
      3. square-root heuristic: b ~= sqrt(num_perm), decremented until it
         divides num_perm.
    Always returns a pair with ``b * r == num_perm``.
    """
    if num_perm in PRECOMPUTED_CONFIGS:
        row = PRECOMPUTED_CONFIGS[num_perm]
        if row:
            closest = min(row.keys(), key=lambda t: abs(t - target_threshold))
            if abs(closest - target_threshold) <= _THRESHOLD_MATCH_TOL:
                return row[closest]

    config = find_optimal_br(num_perm, target_threshold)
    if config:
        return config

    b = int(math.isqrt(num_perm))
    while num_perm % b:
        b -= 1
    return b, num_perm // b


def print_config_analysis(num_perm: int, threshold: float = 0.5) -> None:
    """Print a human-readable tuning report for the chosen configuration."""
    b, r = get_optimal_config(num_perm, threshold)
    actual = compute_lsh_threshold(b, r)
    fp, fn = compute_false_rates(b, r, threshold)
    print("LSH Configuration Analysis")
    print("=" * 50)
    print(f"Number of permutations: {num_perm}")
    print(f"Target threshold: {threshold:.2f}")
    print("\nOptimal configuration:")
    print(f"  Bands (b): {b}")
    print(f"  Rows per band (r): {r}")
    print("\nPerformance metrics:")
    print(f"  Actual threshold: {actual:.4f}")
    print(f"  False positive rate: {fp:.2%}")
    print(f"  False negative rate: {fn:.2%}")
    print(f"  S-curve steepness: {b * r}")
    print("\nDetection probabilities:")
    for s in (0.3, 0.5, 0.7, 0.9):
        p = compute_collision_probability(s, b, r)
        print(f"  Similarity {s}: {p:.2%} chance of detection")


if __name__ == "__main__":
    # Demo: tuning analysis across common hash budgets (mirrors the
    # reference's __main__ block behaviourally).
    for num_perm in (128, 256, 4096):
        for threshold in (0.5, 0.8, 0.9):
            print_config_analysis(num_perm, threshold)
            print()
