"""Build and load the hand-written CUDA kernels (``lshrs_tpu_torch/csrc``).

The ``.cu`` sources compile with ``nvcc`` for Hopper (``sm_90a``), one
compiler process per source, all at once, and link into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The
build runs at first use, never at import, into ``build/lshrs_tpu_torch/``
beside the package (listed in ``.gitignore``). The library file is named
by a hash of the sources and flags, so an edited source rebuilds, and it
is written to a temporary name and renamed into place, so a process never
loads a half-written file.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = (
    "collision_group_max.cu",
    "hamming_group_max.cu",
    "hamming_packed_group_max.cu",
    "hamming_refine_topk.cu",
    "group_select.cu",
)
# Included by the sources above (B2 and B3 share its pipeline): part of the
# library's hash, so an edited header rebuilds too.
_HEADERS = ("hamming_wgmma.cuh",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lshrs_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
# Every entry point returns a cudaError_t (0 = launched).
_SIGNATURES = {
    # sig_t, tie, qwords, out, q, c, bw, words, probes, group, scale,
    # num_bands, stream
    "lshrs_collision_group_max": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    # planes, tie, qbits, out, q, c, p, group, scale, offset, shift,
    # dead_bias, stream
    "lshrs_hamming_group_max": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    # sig_t, tie, qop, out, q, c, bw, word_bits, kp, group, scale,
    # num_perm, stream
    "lshrs_hamming_packed_group_max": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    # rows, groups, qwords, out_h, out_ids, q, m, nw, group, k, p,
    # tie_bits, stream
    "lshrs_hamming_refine_topk": [_P] * 5 + [_I] * 7 + [_P],
    # keys, out, q, ng, m, stream
    "lshrs_group_select": [_P] * 2 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels in "
        f"{_CSRC} need the CUDA toolkit to build"
    )


def _check(cmd: list[str], proc: subprocess.Popen) -> None:
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{stderr}{stdout}"
        )


def _compile(so_path: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        try:
            for name in _SOURCES:
                obj = Path(tmp) / f"{Path(name).stem}.o"
                cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(_CSRC / name)]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
                )
                jobs.append((cmd, proc, obj))
            for cmd, proc, _ in jobs:
                _check(cmd, proc)
        finally:
            for _, proc, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_so = Path(tmp) / "kernels.so"
        cmd = [nvcc, "-shared", *_FLAGS[:2], "-o", str(tmp_so)]
        cmd += [str(obj) for _, _, obj in jobs]
        _check(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
        tmp_so.replace(so_path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256(" ".join(_FLAGS).encode())
            for name in _SOURCES + _HEADERS:
                h.update(name.encode())
                h.update((_CSRC / name).read_bytes())
            so_path = BUILD_DIR / f"lshrs_kernels-{h.hexdigest()[:16]}.so"
            if not so_path.exists():
                _compile(so_path)
            lib = ctypes.CDLL(str(so_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
