// Kernel B1: band-collision count -> packed (count, tie) key -> group max.
//
// Replaces lshrs_tpu/ops/pallas_scan.py::group_max_keys (kernel body
// _make_kernel). For each (query, slot): count the bands whose words all
// equal the query's, counting a match against any probe; key =
// count * scale + bias, bias = tie for alive slots (tie >= 0) and
// -num_bands * scale for dead ones; write the max key of each group of
// `group` CONTIGUOUS slots (group g = slots g*group .. g*group+group-1).
// The TPU kernel grouped slots strided within a chunk, for Mosaic; this
// one does not, so the store keeps one contiguous refine-table geometry.
//
// What bounds it on the H100: integer ALU work, Q * C * BW * probes word
// compares (plus the and/add that fold them into counts). The store is
// small next to L2 (BW * C * 4 bytes: 8 MB at 16 bands x 131072 slots),
// and the output is C / group times smaller than the per-slot keys.
//
// Design (simple first version): one thread per query, 128 queries per
// block. Each thread keeps its query's probes * BW words in registers
// (template instantiations for the common word counts; a generic
// instantiation re-reads them through L1). The block stages a tile of
// sig_t columns and their key bias in shared memory; every thread of a
// warp reads the same slot, so the reads broadcast, four slots per
// 16-byte load. The running group max stays in a register and is written
// once per group. Blocks cover whole groups, so nothing is carried
// between blocks.
//
// Register instantiations (nvcc 12.8, -O3, sm_90a, -Xptxas -v; 128 threads
// per block, so up to 255 registers per thread are allowed):
//   <BW, W, P>   registers  spill (stores / loads, bytes)
//   <16, 1, 1>       48       0 / 0
//   <16, 1, 2>       80      12 / 12
//   <16, 1, 4>      152       0 / 0
//   <32, 1, 1>       64       0 / 0
//   <32, 1, 2>      180       0 / 0
//   <32, 1, 4>      255      80 / 80   (128 query words per thread)
//   <64, 1, 1>       96       0 / 0    (64 x 4 bands: 64 query words)
//   <8, 1, 1> 48, <8, 2, 1> 48 (4 x 64 bands), <4, 1, 1> 32, <4, 2, 1> 39,
//   generic <0, 0, 0> 32: no spills.
// <32, 1, 4> spills 20 of its words to local memory and stays in registers
// all the same: on an H100 it takes 3.2 ms at Q=1024, C=131072 where the
// generic instantiation, which re-reads every query word through L1 in the
// inner loop, takes several times longer on the same count of word
// compares (benchmarks/torch_b1_probe.py times both). The same holds at 64
// band words: on an H100 <64, 1, 1> takes 5.0 ms at Q=512, C=2^20, where
// the generic instantiation takes 56.7 ms on the same compares (32 bands
// of 2 words; chip_smoke.py phase 2 times both).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // queries per block, one per thread
constexpr int kMaxTile = 256;        // slots staged per shared-memory tile
constexpr int kMinSlotsPerBlock = 2048;
constexpr size_t kSmemBudget = 48 * 1024;

template <int BW, int W, int P>
__global__ void __launch_bounds__(kThreads) collision_group_max_kernel(
    const int32_t* __restrict__ sig_t,   // (bw, c) transposed store
    const int32_t* __restrict__ tie,     // (c,) tie key, -1 = dead
    const int32_t* __restrict__ qwords,  // (q, probes * bw) probe-major
    int32_t* __restrict__ out,           // (q, c / group) group-max keys
    int q, int c, int bw_rt, int w_rt, int probes_rt, int group, int scale,
    int dead_bias, int tile, int slots_per_block) {
  constexpr bool kReg = BW > 0;
  const int bw = kReg ? BW : bw_rt;
  const int w = kReg ? W : w_rt;
  const int probes = kReg ? P : probes_rt;
  const int qlen = probes * bw;

  extern __shared__ int4 smem4[];
  int32_t* s_sig = reinterpret_cast<int32_t*>(smem4);  // [bw][tile]
  int32_t* s_bias = s_sig + bw * tile;                  // [tile]

  const int qi = blockIdx.y * kThreads + threadIdx.x;
  const bool active = qi < q;
  const int32_t* qrow = qwords + static_cast<size_t>(active ? qi : 0) * qlen;
  int32_t qreg[kReg ? P * BW : 1];
  if constexpr (kReg) {
#pragma unroll
    for (int i = 0; i < P * BW; ++i) qreg[i] = qrow[i];
  }

  const int ng = c / group;
  const int s_begin = blockIdx.x * slots_per_block;
  const int s_end = min(c, s_begin + slots_per_block);
  int run = INT_MIN;
  for (int t0 = s_begin; t0 < s_end; t0 += tile) {
    const int n = min(tile, s_end - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < bw * tile; idx += kThreads) {
      const int row = idx / tile;
      const int col = idx - row * tile;
      if (col < n) s_sig[idx] = sig_t[static_cast<size_t>(row) * c + t0 + col];
    }
    for (int col = threadIdx.x; col < n; col += kThreads) {
      const int32_t tv = tie[t0 + col];
      s_bias[col] = tv >= 0 ? tv : dead_bias;
    }
    __syncthreads();
    if (!active) continue;

    for (int s = 0; s < n; s += 4) {  // n is a multiple of group, group of 4
      int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
      if constexpr (kReg) {
#pragma unroll
        for (int t = 0; t < P; ++t) {
#pragma unroll
          for (int b = 0; b < BW / W; ++b) {
            bool e0 = true, e1 = true, e2 = true, e3 = true;
#pragma unroll
            for (int j = 0; j < W; ++j) {
              const int row = b * W + j;
              const int4 v = *reinterpret_cast<const int4*>(s_sig + row * tile + s);
              const int32_t qv = qreg[t * BW + row];
              e0 &= v.x == qv;
              e1 &= v.y == qv;
              e2 &= v.z == qv;
              e3 &= v.w == qv;
            }
            c0 += e0;
            c1 += e1;
            c2 += e2;
            c3 += e3;
          }
        }
      } else {
        const int nb = bw / w;
        for (int t = 0; t < probes; ++t) {
          for (int b = 0; b < nb; ++b) {
            bool e0 = true, e1 = true, e2 = true, e3 = true;
            for (int j = 0; j < w; ++j) {
              const int row = b * w + j;
              const int4 v = *reinterpret_cast<const int4*>(s_sig + row * tile + s);
              const int32_t qv = __ldg(qrow + t * bw + row);
              e0 &= v.x == qv;
              e1 &= v.y == qv;
              e2 &= v.z == qv;
              e3 &= v.w == qv;
            }
            c0 += e0;
            c1 += e1;
            c2 += e2;
            c3 += e3;
          }
        }
      }
      const int4 bias = *reinterpret_cast<const int4*>(s_bias + s);
      const int k01 = max(c0 * scale + bias.x, c1 * scale + bias.y);
      const int k23 = max(c2 * scale + bias.z, c3 * scale + bias.w);
      run = max(run, max(k01, k23));
      const int last = t0 + s + 3;
      if (((last + 1) & (group - 1)) == 0) {  // the quad closed a group
        out[static_cast<size_t>(qi) * ng + last / group] = run;
        run = INT_MIN;
      }
    }
  }
}

template <int BW, int W, int P>
int launch(const int32_t* sig_t, const int32_t* tie, const int32_t* qwords,
           int32_t* out, int q, int c, int bw, int w, int probes, int group,
           int scale, int dead_bias, int tile, int spb, cudaStream_t stream) {
  const dim3 grid((c + spb - 1) / spb, (q + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(bw + 1) * tile * sizeof(int32_t);
  collision_group_max_kernel<BW, W, P><<<grid, kThreads, smem, stream>>>(
      sig_t, tie, qwords, out, q, c, bw, w, probes, group, scale, dead_bias,
      tile, spb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 on a launched kernel. The caller validates
// shapes; an argument this kernel cannot take returns
// cudaErrorInvalidValue without launching.
extern "C" int lshrs_collision_group_max(
    const void* sig_t, const void* tie, const void* qwords, void* out, int q,
    int c, int bw, int words, int probes, int group, int scale, int num_bands,
    void* stream) {
  if (q <= 0 || c <= 0 || bw <= 0 || words <= 0 || probes <= 0 ||
      bw != num_bands * words || group < 4 || (group & (group - 1)) != 0 ||
      c % group != 0 || q > 65535 * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile = kMaxTile;
  while (tile > 4 &&
         static_cast<size_t>(bw + 1) * tile * sizeof(int32_t) > kSmemBudget) {
    tile >>= 1;
  }
  if (static_cast<size_t>(bw + 1) * tile * sizeof(int32_t) > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spb = max(max(group, kMinSlotsPerBlock), tile);
  const int dead_bias = -num_bands * scale;
  const auto* s = static_cast<const int32_t*>(sig_t);
  const auto* t = static_cast<const int32_t*>(tie);
  const auto* qw = static_cast<const int32_t*>(qwords);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define LSHRS_B1_CASE(BW_, W_, P_)                                          \
  if (bw == BW_ && words == W_ && probes == P_) {                           \
    return launch<BW_, W_, P_>(s, t, qw, o, q, c, bw, words, probes, group, \
                               scale, dead_bias, tile, spb, st);            \
  }
  LSHRS_B1_CASE(16, 1, 1)
  LSHRS_B1_CASE(16, 1, 2)
  LSHRS_B1_CASE(16, 1, 4)
  LSHRS_B1_CASE(32, 1, 1)
  LSHRS_B1_CASE(32, 1, 2)
  LSHRS_B1_CASE(32, 1, 4)
  LSHRS_B1_CASE(8, 1, 1)
  LSHRS_B1_CASE(4, 1, 1)
  LSHRS_B1_CASE(4, 2, 1)
  LSHRS_B1_CASE(64, 1, 1)
  LSHRS_B1_CASE(8, 2, 1)
#undef LSHRS_B1_CASE
  return launch<0, 0, 0>(s, t, qw, o, q, c, bw, words, probes, group, scale,
                         dead_bias, tile, spb, st);
}
