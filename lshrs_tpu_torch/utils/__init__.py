"""Utility helpers exposed for convenient imports."""

from .br import (
    PRECOMPUTED_CONFIGS,
    compute_collision_probability,
    compute_false_rates,
    compute_lsh_threshold,
    find_optimal_br,
    get_optimal_config,
    print_config_analysis,
)
from .cp import (
    compute_cp_false_rates,
    cp_collision_probability,
    find_optimal_cp_br,
    get_optimal_cp_config,
)
from .norm import l2_norm
from .similarity import cosine_similarity, top_k_cosine

__all__ = [
    "PRECOMPUTED_CONFIGS",
    "compute_collision_probability",
    "compute_false_rates",
    "compute_lsh_threshold",
    "find_optimal_br",
    "get_optimal_config",
    "print_config_analysis",
    "compute_cp_false_rates",
    "cp_collision_probability",
    "find_optimal_cp_br",
    "get_optimal_cp_config",
    "l2_norm",
    "cosine_similarity",
    "top_k_cosine",
]
