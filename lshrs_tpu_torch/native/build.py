"""Lazy, cached compilation of the native host-path helpers.

The serving host compiles ``fwht.c`` once per (source, compiler-flag)
hash into ``$LSHRS_TPU_NATIVE_CACHE`` (default ``build/lshrs_tpu_torch/``
beside the package, the directory the CUDA kernels build into) and
ctypes-loads it.  Any failure — no compiler, read-only filesystem,
exotic platform — degrades to the NumPy implementation, which is
bit-identical, just slower; :func:`native_status` says which one runs
and why.  ``-march=native`` is safe because the .so never leaves this
machine; ``-ffast-math`` is deliberately absent (see ``fwht.c`` —
reassociation would break cross-path bit parity).

This is a host path with a bit-identical twin, not a device kernel: the
CUDA kernels (`lshrs_tpu_torch.ops._build`) have no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_SRC = Path(__file__).with_name("fwht.c")
_DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "build" / "lshrs_tpu_torch"

_cached: ctypes.CDLL | None = None
_cache_attempted = False
_status = "not attempted"


def native_cache_dir() -> Path:
    root = os.environ.get("LSHRS_TPU_NATIVE_CACHE")
    return Path(root) if root else _DEFAULT_CACHE


def native_status() -> str:
    """``"loaded: <path>"`` once the C library serves the host FWHT, else
    the reason the NumPy path runs (``"not attempted"`` before the first
    host hash)."""
    return _status


def _compiler() -> str | None:
    for cc in (os.environ.get("CC"), "cc", "gcc", "g++", "clang"):
        if not cc:
            continue
        try:
            subprocess.run(
                [cc, "--version"], capture_output=True, timeout=10, check=True
            )
            return cc
        except Exception:
            continue
    return None


def load_fwht_library() -> ctypes.CDLL | None:
    """Compile (once) and load the FWHT library; None if unavailable."""
    global _cached, _cache_attempted, _status
    if _cache_attempted:
        return _cached
    _cache_attempted = True
    if os.environ.get("LSHRS_TPU_DISABLE_NATIVE"):
        _status = "disabled by LSHRS_TPU_DISABLE_NATIVE"
        return None
    try:
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
        cache = native_cache_dir()
        cache.mkdir(parents=True, exist_ok=True)
        so_path = cache / f"fwht_host-{tag}.so"
        if not so_path.exists():
            cc = _compiler()
            if cc is None:
                _status = "no C compiler found (CC, cc, gcc, g++, clang)"
                return None
            # build to a temp name then atomic-rename: concurrent processes
            # racing the first compile must never load a half-written .so
            with tempfile.NamedTemporaryFile(
                dir=cache, suffix=".so.tmp", delete=False
            ) as tmp:
                tmp_path = Path(tmp.name)
            try:
                subprocess.run(
                    [cc, *_FLAGS, "-o", str(tmp_path), str(_SRC)],
                    capture_output=True,
                    timeout=120,
                    check=True,
                )
                tmp_path.replace(so_path)
            finally:
                tmp_path.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(so_path))
        fn = lib.fwht_structured
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_long,    # n
            ctypes.c_long,    # dim
            ctypes.c_void_p,  # diags
            ctypes.c_long,    # nblocks
            ctypes.c_long,    # dpad
            ctypes.c_long,    # num_perm
            ctypes.c_void_p,  # out
        ]
        _cached = lib
        _status = f"loaded: {so_path}"
    except Exception as e:
        _cached = None
        _status = f"failed: {type(e).__name__}: {e}"
    return _cached
