// Kernel B2: int8 bitplane dot -> packed (scaled dot, tie) key -> group max.
//
// Replaces lshrs_tpu/ops/pallas_scan.py::hamming_group_max_keys (kernel
// body _make_hamming_kernel). For each (query, slot): dot = qbits . planes
// over P int8 values, accumulated in int32; key = ((dot + offset) >> shift)
// * scale + bias, bias = tie + scale for alive slots and -maxscaled *
// scale for dead ones; write the max key of each group of `group`
// CONTIGUOUS slots. Symmetric Hamming ranking is offset = P, shift = 1
// with +-1 query planes; asymmetric ranking feeds quantised coordinates
// with offset = P * qmax and a shift that keeps the key in int32.
//
// What bounds it on the H100: the int8 multiply-adds, 2 * Q * C * P
// operations (4.4 T at Q = 8192, C = 2^20, P = 256). Bytes are minor:
// the planes (C * P bytes, 256 MB at 1M slots) stream once per grid pass
// because blocks that run together share a plane tile, the queries
// (Q * P bytes) sit in L2, and the output is group times smaller than the
// (Q, C) dot matrix, which never leaves registers.
//
// Design (simple first version): a block computes a 128-query x
// 128-slot tile with 256 threads, each an 8 x 8 micro-tile of int32
// accumulators fed by __dp4a (four int8 products per instruction).
// The P axis streams through shared memory 64 bytes at a time, stored
// word-transposed (padded) so the per-thread operand reads are conflict
// free. The epilogue builds the keys in registers, takes the max over
// the thread's slots of each group, then over the 16 threads that share
// the group with warp shuffles, and writes one key per (query, group).
// The tensor-core path (mma.sync / wgmma on s8) is later work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kQT = 128;      // queries per block tile
constexpr int kCT = 128;      // slots per block tile
constexpr int kKW = 16;       // 32-bit words (64 int8 values) per P stage
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStride = kQT + 1;  // padded row of the transposed tiles

template <int G>
__global__ void __launch_bounds__(kThreads) hamming_group_max_kernel(
    const int32_t* __restrict__ planes,  // (c, pw) words of 4 int8
    const int32_t* __restrict__ tie,     // (c,) tie key, -1 = dead
    const int32_t* __restrict__ qbits,   // (q, pw) words of 4 int8
    int32_t* __restrict__ out,           // (q, c / G) group-max keys
    int q, int c, int pw, int scale, int offset, int shift, int dead_bias,
    int nqt) {
  static_assert(G % 16 == 0 && kCT % G == 0, "group must divide the tile");
  constexpr int kPer = G / 16;      // a thread's slots in one group
  constexpr int kGroups = kCT / G;  // groups per slot tile

  __shared__ int32_t s_q[kKW * kStride];
  __shared__ int32_t s_p[kKW * kStride];
  __shared__ int32_t s_bias[kCT];

  const int q0 = (blockIdx.x % nqt) * kQT;  // query tiles vary fastest:
  const int c0 = (blockIdx.x / nqt) * kCT;  // co-resident blocks share planes
  const int tx = threadIdx.x & 15;          // slots tx + 16 * i
  const int ty = threadIdx.x >> 4;          // queries ty + 16 * j

  for (int i = threadIdx.x; i < kCT; i += kThreads) {
    const int slot = c0 + i;
    const int32_t tv = slot < c ? tie[slot] : -1;
    s_bias[i] = tv >= 0 ? tv + scale : dead_bias;
  }

  int acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0;
  }

  for (int k0 = 0; k0 < pw; k0 += kKW) {
    __syncthreads();  // every thread is done with the previous stage
    for (int idx = threadIdx.x; idx < kQT * kKW; idx += kThreads) {
      const int row = idx / kKW;
      const int kw = idx % kKW;
      const int gk = k0 + kw;
      const int gq = q0 + row;
      const int gc = c0 + row;
      s_q[kw * kStride + row] =
          (gq < q && gk < pw) ? qbits[static_cast<size_t>(gq) * pw + gk] : 0;
      s_p[kw * kStride + row] =
          (gc < c && gk < pw) ? planes[static_cast<size_t>(gc) * pw + gk] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = s_q[kw * kStride + ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = s_p[kw * kStride + tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = __dp4a(a[j], b[i], acc[j][i]);
      }
    }
  }

  const int ng = c / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gq = q0 + ty + 16 * j;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      int m = INT_MIN;
#pragma unroll
      for (int ii = 0; ii < kPer; ++ii) {
        const int i = g * kPer + ii;
        const int key =
            ((acc[j][i] + offset) >> shift) * scale + s_bias[tx + 16 * i];
        m = max(m, key);
      }
      // The 16 threads with this ty hold the group's other slots.
#pragma unroll
      for (int lane = 8; lane > 0; lane >>= 1) {
        m = max(m, __shfl_xor_sync(0xffffffffu, m, lane));
      }
      const int first = c0 + g * G;
      if (tx == 0 && gq < q && first < c) {
        out[static_cast<size_t>(gq) * ng + first / G] = m;
      }
    }
  }
}

template <int G>
int launch(const int32_t* planes, const int32_t* tie, const int32_t* qbits,
           int32_t* out, int q, int c, int pw, int scale, int offset,
           int shift, int dead_bias, cudaStream_t stream) {
  const int nqt = (q + kQT - 1) / kQT;
  const long long blocks =
      static_cast<long long>(nqt) * ((c + kCT - 1) / kCT);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  hamming_group_max_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(planes, tie, qbits, out, q, c, pw,
                                          scale, offset, shift, dead_bias, nqt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 on a launched kernel. The caller validates
// shapes; an argument this kernel cannot take (P not a multiple of 4,
// group outside {16, 32, 64, 128}, C not a multiple of group) returns
// cudaErrorInvalidValue without launching.
extern "C" int lshrs_hamming_group_max(const void* planes, const void* tie,
                                       const void* qbits, void* out, int q,
                                       int c, int p, int group, int scale,
                                       int offset, int shift, int dead_bias,
                                       void* stream) {
  if (q <= 0 || c <= 0 || p <= 0 || p % 4 != 0 || c % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* pl = static_cast<const int32_t*>(planes);
  const auto* t = static_cast<const int32_t*>(tie);
  const auto* qb = static_cast<const int32_t*>(qbits);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int pw = p / 4;
  switch (group) {
    case 16:
      return launch<16>(pl, t, qb, o, q, c, pw, scale, offset, shift, dead_bias, st);
    case 32:
      return launch<32>(pl, t, qb, o, q, c, pw, scale, offset, shift, dead_bias, st);
    case 64:
      return launch<64>(pl, t, qb, o, q, c, pw, scale, offset, shift, dead_bias, st);
    case 128:
      return launch<128>(pl, t, qb, o, q, c, pw, scale, offset, shift, dead_bias, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
