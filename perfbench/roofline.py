"""The H100's published peaks and the least time a kernel's work needs.

Frozen copy of ``chip_smoke.py:509-536`` (``kernel_bound``) and its
constants, with ``plane_width`` (``lshrs_tpu_torch/ops/hamming.py``)
written out here: the benchmark keeps its own yardstick.
"""

from __future__ import annotations

__all__ = ["H100_HBM_BYTES", "H100_INT32_OPS", "H100_INT8_OPS", "kernel_bound", "plane_width"]

# NVIDIA's data sheet, H100 SXM, dense: 1,979 TOP/s int8 and 3.35 TB/s of
# HBM3. The int32 ALU: 64 lanes an SM, 132 SMs, 1.98 GHz boost.
H100_INT8_OPS = 1.979e15
H100_HBM_BYTES = 3.35e12
H100_INT32_OPS = 64 * 132 * 1.98e9


def plane_width(p: int) -> int:
    """Bytes of one bitplane row: ``p`` bits as int8, padded to 32."""
    return -(-p // 32) * 32


def kernel_bound(name: str, shape: dict) -> tuple[float, str]:
    """The least time (ms) the H100 could take for a kernel's work at
    ``shape``, and what sets it: the larger of the operations at their
    peak rate and the bytes (each input read once, the output written
    once) at the HBM rate."""
    c, q = shape["C"], shape["Q"]
    if name.startswith("group_max_keys"):
        # B1: one compare per band word per probe, an ISETP on the int32
        # ALU (the count's predicated add issues on another pipe).
        bw, probes = shape["bands"], shape["probes"]
        ops, rate = q * c * probes * bw, H100_INT32_OPS
        nbytes = 4 * (bw * c + c + q * probes * bw + q * (c // 64))
    elif name.startswith("hamming_group_max_keys"):  # B2: int8 multiply-adds
        p, width = shape["P"], plane_width(shape["P"])
        ops, rate = 2 * q * c * p, H100_INT8_OPS
        nbytes = c * width + 4 * c + q * width + 4 * q * (c // shape["group"])
    else:  # B3: the same int8 +-1 product as B2, K = BW * word_bits padded to 32
        bw = shape["BW"]
        ops, rate = 2 * q * c * plane_width(bw * shape["word_bits"]), H100_INT8_OPS
        nbytes = 4 * (bw * c + c + q * bw + q * (c // shape["group"]))
    op_ms, byte_ms = ops / rate * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")
