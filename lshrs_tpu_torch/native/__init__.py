"""Native (C) host-path helpers, compiled on first use and loaded with
ctypes. Bit-identical to the NumPy fallbacks; they exist for host
throughput only."""

from lshrs_tpu_torch.native.build import (
    load_fwht_library,
    native_cache_dir,
    native_status,
)

__all__ = ["load_fwht_library", "native_cache_dir", "native_status"]
