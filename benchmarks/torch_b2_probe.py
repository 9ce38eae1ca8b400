"""Where kernel B2's time goes on an H100: phase clocks, the wgmma rate, schedules.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 benchmarks/torch_b2_probe.py

It builds copies of ``lshrs_tpu_torch/csrc/hamming_group_max.cu`` into
``build/b2_probe/`` (one nvcc each, in parallel) and prints three JSON lines:

1. ``phases``: the kernel with ``clock64()`` stamps around each phase of a
   query tile (wait for the slot tile, wait for the turn at the tensor
   cores, wait for the query k-block, issue the wgmmas, drain them, the
   epilogue, the release), recorded by block 0; the median clocks of each
   phase per consumer warpgroup over its tiles 4-63, at C = 2**20, P = 256,
   group 64 and Q = 512 and 8192;
2. ``wgmma_rate``: TOP/s of a stream of the kernel's own m64n256k32 s8
   wgmmas on resident shared-memory tiles, one and two warpgroups, on 132
   blocks (the tensor cores' reachable rate with no loads or epilogue);
3. ``schedules``: median CUDA-event ms of the kernel as committed
   (consumers take turns at the tensor cores) against the same source
   with the turn barriers removed (free-running) or replaced by one that
   starts both consumers' tiles together (lockstep), in turns, all
   checked bit for bit against the plain version.

The stamps and variants are text edits of a copy; the committed kernel is
never changed. Numbers depend on the card: compare within one run.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lshrs_tpu_torch.ops import _build  # noqa: E402
from lshrs_tpu_torch.ops import group_max as gm  # noqa: E402
from lshrs_tpu_torch.ops.scan import global_tie_core  # noqa: E402

SRC = ROOT / "lshrs_tpu_torch" / "csrc" / "hamming_group_max.cu"
OUT = ROOT / "build" / "b2_probe"
C, P, GROUP = 1 << 20, 256, 64
PHASES = ("slot_tile_wait", "turn_wait", "query_wait", "issue", "drain", "epilogue", "release")
TURN_SYNC = '    if (k > 0) asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");\n'
TURN_PASS = ('      if (kb == nkb - 1 && k + 1 < K) {\n'
             '        asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");\n      }\n')


def edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"probe anchor not found once in {SRC.name}: {old!r}")
    return text.replace(old, new)


def phase_source(src: str) -> str:
    """The kernel with clock64 stamps T[0..7] around each phase of a tile."""
    src = edit(src, "template <int G>\n__global__",
               "__device__ long long g_stamps[2][64][8];\n\ntemplate <int G>\n__global__")
    src = edit(src, "  int s = 0, phase = 0;  // the next query stage and its fill parity\n",
               "  int s = 0, phase = 0;  // the next query stage and its fill parity\n"
               "  int ntl = 0;\n  long long T[8];\n")
    src = edit(src, "    if (j > waited) wait_tile(j);\n    const uint32_t planes_base",
               "    T[0] = clock64();\n    if (j > waited) wait_tile(j);\n    T[1] = clock64();\n"
               "    const uint32_t planes_base")
    src = edit(src, TURN_SYNC, TURN_SYNC + "    T[2] = clock64();\n")
    src = edit(src, "      mbar_wait(full_bar(wg, s), static_cast<uint32_t>(phase));\n",
               "      mbar_wait(full_bar(wg, s), static_cast<uint32_t>(phase));\n"
               "      if (kb == 0) T[3] = clock64();\n")
    src = edit(src, "    wgmma_wait<0>();\n    mbar_arrive(empty_bar(wg, prev));\n",
               "    T[4] = clock64();\n    wgmma_wait<0>();\n    mbar_arrive(empty_bar(wg, prev));\n"
               "    T[5] = clock64();\n")
    src = edit(src, "    release_to(k + 2 < K ? (k + 2) / nqt : nt);\n  }\n}",
               "    T[6] = clock64();\n    release_to(k + 2 < K ? (k + 2) / nqt : nt);\n"
               "    T[7] = clock64();\n"
               "    if (blockIdx.x == 0 && t128 == 0 && ntl < 64) {\n"
               "      for (int e = 0; e < 8; ++e) g_stamps[wg][ntl][e] = T[e];\n    }\n"
               "    ++ntl;\n  }\n}")
    return src + ('\nextern "C" int probe_stamps(void* host) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)));\n}\n")


def rate_source(src: str) -> str:
    """A kernel issuing the B2 kernel's own wgmma on fixed tiles, nothing else."""
    helpers = src[: src.index("// The max of 4 groups")]
    return helpers + r'''
__global__ void __launch_bounds__(256, 1) wgmma_rate(int iters, int nwg, int* out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  if (wg >= nwg) return;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  const uint32_t a = base + kBBytes + wg * kABytes;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_s8(acc, smem_desc(a + ks * 32), smem_desc(base + ks * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) sum += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}
}  // namespace

extern "C" int probe_wgmma_rate(int blocks, int iters, int nwg, void* out) {
  const int smem = kBBytes + 2 * kABytes + 1024;
  cudaFuncSetAttribute(wgmma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_rate<<<blocks, 256, smem>>>(iters, nwg, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, in parallel, each into a shared library."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_build._FLAGS, "-shared", "-o", str(OUT / f"{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in jobs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b2_probe: no CUDA device available", file=sys.stderr)
        return 1
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    src = SRC.read_text()
    free = edit(edit(src, TURN_SYNC, ""), TURN_PASS, "")
    lock = edit(edit(src, TURN_SYNC, '    if (k - wg + 1 < K) asm volatile("bar.sync 3, 256;" ::: "memory");\n'),
                TURN_PASS, "")
    libs = build({"turns": src, "free": free, "lockstep": lock,
                  "phases": phase_source(src), "rate": rate_source(src)})
    for lib in libs.values():
        if hasattr(lib, "lshrs_hamming_group_max"):
            lib.lshrs_hamming_group_max.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    libs["rate"].probe_wgmma_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    libs["phases"].probe_stamps.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    planes = torch.from_numpy((2 * rng.integers(0, 2, (C, P)) - 1).astype(np.int8)).to(dev)
    ids = rng.permutation(C).astype(np.int32)
    ids[rng.random(C) < 0.1] = -1
    tie = global_tie_core(torch.from_numpy(ids).to(dev))
    scale = gm.key_scale(C)
    queries = {q: torch.from_numpy(rng.integers(-1, 2, (q, P)).astype(np.int8)).to(dev) for q in (512, 8192)}

    def run(lib, qb):
        out = torch.empty((qb.shape[0], C // GROUP), dtype=torch.int32, device=dev)
        rc = lib.lshrs_hamming_group_max(planes.data_ptr(), tie.data_ptr(), qb.data_ptr(), out.data_ptr(),
                                         qb.shape[0], C, P, GROUP, scale, P, 1, -P * scale,
                                         torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return out

    phases = {}
    for q, qb in queries.items():
        run(libs["phases"], qb)
        torch.cuda.synchronize()
        stamps = np.zeros((2, 64, 8), np.int64)
        if libs["phases"].probe_stamps(stamps.ctypes.data_as(ctypes.c_void_p)):
            raise RuntimeError("could not read the stamps")
        spans = np.diff(stamps[:, 4:], axis=2)  # (warpgroup, tile, phase)
        phases[f"Q{q}"] = {f"wg{w}": dict(zip(PHASES, np.median(spans[w], axis=0).tolist()))
                           for w in range(2)}
    print(json.dumps({"probe": "phases", "card": label, "C": C, "P": P, "group": GROUP,
                      "median_clocks": phases}))

    counter = torch.empty(132 * 256, dtype=torch.int32, device=dev)
    rates = {}
    for nwg in (1, 2):
        iters = 20000
        ms = median_ms(lambda: libs["rate"].probe_wgmma_rate(132, iters, nwg, counter.data_ptr()), 5)
        rates[f"{nwg}_warpgroups_tops"] = 132 * nwg * iters * 4 * (64 * 256 * 32 * 2) / (ms * 1e-3) / 1e12
    print(json.dumps({"probe": "wgmma_rate", "card": label, "blocks": 132, **rates}))

    want = gm.hamming_group_max_keys_ref(planes, tie, queries[512], group=GROUP, scale=scale)
    times = {}
    for name in ("turns", "free", "lockstep"):
        if not torch.equal(run(libs[name], queries[512]), want):
            raise AssertionError(f"the {name} schedule differs from the plain version")
    for name in ("turns", "free", "lockstep", "lockstep", "free", "turns"):
        for q, qb in queries.items():
            times.setdefault(f"{name}_Q{q}_ms", []).append(
                median_ms(lambda: run(libs[name], qb), 20 if q == 512 else 5))
    print(json.dumps({"probe": "schedules", "card": label, "C": C, "P": P, "group": GROUP, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
