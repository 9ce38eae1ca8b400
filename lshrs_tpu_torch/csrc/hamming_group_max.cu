// Kernel B2: int8 bitplane dot -> packed (scaled dot, tie) key -> group max,
// on Hopper's int8 tensor cores (wgmma, operands loaded by TMA).
//
// Replaces lshrs_tpu/ops/pallas_scan.py::hamming_group_max_keys (kernel
// body _make_hamming_kernel). For each (query, slot): dot = qbits . planes
// over the P int8 columns, in int32; key = ((dot + offset) >> shift) *
// scale + bias, bias = tie + scale for alive slots and dead_bias =
// -((2 * offset) >> shift) * scale for dead ones; write the max key of each
// group of `group` CONTIGUOUS slots, (Q, C / group) int32. The operands
// arrive with their rows padded to a multiple of 16 bytes (the store pads
// P to a multiple of 32 with zero columns, which add nothing to the dot).
//
// What bounds it on the H100:
//   1. the tensor cores: 2 * Q * C * P int8 operations at 1,979 TOP/s
//      (0.139 ms at Q = 512, C = 2^20, P = 256; 2.22 ms at Q = 8192);
//   2. the epilogue, in practice the larger: an add, a shift, a
//      multiply-add and half a 3-input max per (query, slot) on the int32
//      pipes, against 512 tensor-core operations for the same output;
//   3. bytes are minor: the planes (C * P) are read from HBM once, the
//      group maxima (Q * C / group * 4) written once, the queries re-read
//      from L2 (Q * P * C / 256: 8.6 GB at Q = 8192, C = 2^20, P = 256).
//
// Design. A persistent grid, one block per SM, walks 256-slot tiles. A
// slot tile's planes stay resident in shared memory (TMA, 128-byte
// swizzle, 128-byte k-blocks; the next tile's planes prefetched into a
// second buffer where it fits) with its 256 key biases, and every 64-query
// tile of the batch streams past it. Warps: two consumer warpgroups, one
// producer warp per consumer that keeps its ring of query k-block stages
// full (full / empty mbarriers), and one that fills the slot-tile buffers.
// The block's (slot tile, query tile) pairs go to the two consumers in
// turn, and a pair of named barriers orders them at the tensor cores: a
// consumer issues its tile's m64n256k32 wgmmas (.s32.s8.s8, both operands
// K-major in shared memory, 128 int32 accumulators per thread), lets the
// other consumer issue, and turns its accumulators into keys while the
// other's wgmmas run, so the epilogue overlaps the tensor cores. A thread
// holds columns 8j + 2 * (lane % 4) + {0, 1} of two rows: each group's max
// is a max over its registers, then a 3-shuffle reduce-scatter of 4 groups
// over the 4 lanes of a quad. Rows past Q and slots past C are zero-filled
// by TMA and masked on store.
//
// ptxas (sm_90a): 167-168 registers per thread, no spills, 16 named
// barriers, for every group size. On an H100 it reaches ~40% of the
// tensor-core bound at Q = 512 and ~50% at Q = 8192: the epilogue of a
// 64 x 256 tile takes ~1,800-2,400 clocks against ~1,000 for its wgmmas,
// so the tensor cores idle about half the time. Taking turns beats
// free-running and lockstep consumers (benchmarks/torch_b2_probe.py,
// PERF.md).
//
// P past 640 bytes does not fit a resident slot tile: the same loop then
// streams each slot k-block beside its query k-block in the stage (the
// planes re-read from L2 once per query tile), slower but exact.

// The pipeline itself (shared with kernel B3) is in hamming_wgmma.cuh.

#include "hamming_wgmma.cuh"

// Returns a cudaError_t: 0 on a launched kernel. `pp` is the operands' row
// width in bytes (the padded P). The caller validates shapes; an argument
// this kernel cannot take (pp not a multiple of 16, a pointer not 16-byte
// aligned, group outside {16, 32, 64, 128}, C not a multiple of group)
// returns cudaErrorInvalidValue without launching.
extern "C" int lshrs_hamming_group_max(const void* planes, const void* tie, const void* qbits,
                                       void* out, int q, int c, int pp, int group, int scale,
                                       int offset, int shift, int dead_bias, void* stream) {
  if (q <= 0 || c <= 0 || pp <= 0 || pp % 16 != 0 || group <= 0 || c % group != 0 ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qbits) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm{};
  prm.tie = static_cast<const int32_t*>(tie);
  prm.out = static_cast<int32_t*>(out);
  prm.q = q;
  prm.c = c;
  prm.pp = pp;
  prm.nkb = (pp + kKB - 1) / kKB;
  prm.nqt = (q + kBM - 1) / kBM;
  prm.ntiles = (c + kBN - 1) / kBN;
  prm.scale = scale;
  prm.offset = offset;
  prm.shift = shift;
  prm.dead_bias = dead_bias;

  const int smem = plan_smem(prm, false);

  CUtensorMap qmap, pmap;
  if (!make_map(&qmap, qbits, q, pp, kBM) || !make_map(&pmap, planes, c, pp, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_group<false>(group, qmap, pmap, prm, smem, static_cast<cudaStream_t>(stream));
}
