// Kernel B1: band-collision count -> packed (count, tie) key -> group max.
//
// Replaces lshrs_tpu/ops/pallas_scan.py::group_max_keys (kernel body
// _make_kernel). For each (query, slot): count the bands whose W words all
// equal the query's, summed over the query's P probes (a band's probes are
// pairwise distinct, so the sum is the per-band OR); key = count * scale +
// bias, bias = tie for alive slots (tie >= 0) and -num_bands * scale for
// dead ones; write the max key of each group of `group` CONTIGUOUS slots
// (group g = slots g*group .. g*group+group-1). The TPU kernel grouped
// slots strided within a chunk, for Mosaic; this one does not, so the
// store keeps one contiguous refine-table geometry.
//
// What bounds it on the H100: integer work, one compare per band word per
// probe, Q * C * P * BW. A compare is an ISETP on the integer ALU (64
// lanes an SM) and a predicated VIADD, which issues on the FMA pipe
// (inline PTX below: `c += v == q` compiles to a select pair); a two-word
// band is ISETP, ISETP.AND and one VIADD. So the ALU and the issue port
// (one instruction a clock a sub-partition) both allow 64 compares an SM a
// clock (chip_smoke.py::kernel_bound). The store is small next to L2 (8 MB
// at 16 bands x 131072 slots), the output C / group times smaller than the
// per-slot keys. Every thread of a warp compares a different query against
// the same slot words, so a 16-byte read of them from shared memory fills
// 512 bytes of registers, 4 clocks of the SM's 128 bytes a clock: a thread
// compares each read against several word vectors, or the reads bound it.
//
// Design. A block of 128 threads stages a tile of 128 slots of the
// transposed store and their key bias in shared memory; a thread reads
// four slots of a row per 16-byte load, at offsets fixed at compile time,
// keeps four running counts per query and a running group max per query
// in registers, and writes each group's max once. Blocks cover whole
// groups (1,024 slots, or one group if larger), so nothing is carried
// between blocks.
//
// One template, <NQ, W, P>, serves every banding from registers. A thread
// holds NQ = 16 or 32 band words per word vector (the real count is a
// runtime value: bands run in steps of 4 words under a uniform early exit,
// and rows past BW up to the step are zero in shared memory and 1 in the
// registers, so they never match), W = 1 or 2 words per band (a band folds
// into one predicate and one add), and P <= 4 probes of its query,
// innermost, so one read of a slot's words serves P compares; where its
// probes hold at most 32 words (P = 1, or P = 2 at 16 words) it holds two
// queries for the same reason. BW of 33 to 64 splits over two band lanes
// (adjacent threads, each up to 32 words; their rows interleave by steps
// in shared memory, rows of 132 words, so the two lanes of a warp read
// different banks); P past 4 or P * NQ past 96 words splits the probes
// evenly over the fewest probe lanes L that divide them (a warp holds 32 /
// L groups, so 5 or 7 probes leave 2 or 4 threads of 32 idle), and the
// first lane of a group sums the group's counts by a tree of shuffles.
// Only a user's multiprobe setting reaches more than two lanes; they stay
// because the generic instantiation is 5x slower there: 16 x 16 with five
// probes takes 5.6 ms on five lanes, 29.5 ms generic (C = 2^20, Q = 512).
// Fourteen instantiations.
//
// Everything else (W >= 3, BW > 64, or a probe count with no such split,
// as a prime past 32) takes the generic instantiation <0, 0, 0>: runtime
// loops over bands, probes and words, the block's query words staged in
// shared memory transposed ([word][query], stride 129: conflict-free), or
// read from their rows in global memory where they do not fit beside the
// tile. No path of the library sends it a shape; on 16 bands of 3 words
// it takes 11.2 ms at C = 2^20, Q = 512, 14% of the floor above.
//
// Times of every shape (benchmarks/torch_b1_probe.py, chip_smoke.py phase
// 2; NVIDIA H100 80GB HBM3 at 700 W): PERF.md's kernel table.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // threads per block
constexpr int kTile = 128;           // slots staged per shared-memory tile, at most
constexpr int kPad = 4;              // words after each shared row (banks, below)
constexpr int kStep = 4;             // band words per guarded step
constexpr int kSlotsPerBlock = 1024;
constexpr int kMaxRegWords = 96;     // query words a thread holds, at most
constexpr int kQStride = kThreads + 1;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use

struct Args {
  const int32_t* sig_t;   // (bw, c) transposed store
  const int32_t* tie;     // (c,) tie key, -1 = dead
  const int32_t* qwords;  // (q, probes * bw) probe-major
  int32_t* out;           // (q, c / group) group-max keys
  int q, c, bw, w, probes, group, scale, dead_bias;
  int tile;        // slots per tile (kTile on the register path)
  int lanes;       // register path: threads per query, band lanes x probe lanes
  int band_lanes;  // threads that split a probe's band words (1 or 2)
  int lane_rows;   // band words per band lane, a multiple of kStep
  int q_in_smem;   // generic path: query words staged in shared memory
};

// c += (v == q): one compare, one predicated add.
__device__ __forceinline__ void match(int& c, int v, int q) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.s32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c) : "r"(v), "r"(q));
}

// c += (v0 == q0 && v1 == q1): a two-word band in one predicate.
__device__ __forceinline__ void match(int& c, int v0, int q0, int v1, int q1) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.s32 p, %1, %2;\n\t"
      "setp.eq.and.s32 p, %3, %4, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c) : "r"(v0), "r"(q0), "r"(v1), "r"(q1));
}

// Queries a thread of the register path holds: two where its probes hold
// at most 32 words, so that each slot word it reads serves two or more
// compares.
template <int NQ, int P>
constexpr int kQueries = NQ > 0 && NQ * P <= 32 ? 2 : 1;

template <int NQ, int W, int P>
__global__ void __launch_bounds__(kThreads) collision_group_max_kernel(const Args a) {
  constexpr bool kReg = NQ > 0;
  constexpr int QT = kQueries<NQ, P>;
  constexpr int U = QT * P;  // word vectors a thread compares: (query, probe)
  const int tile = kReg ? kTile : a.tile;
  const int stride = tile + kPad;
  const int bw = a.bw;
  const int lanes = kReg ? a.lanes : 1;
  const int band_lanes = kReg ? a.band_lanes : 1;
  const int lane_rows = kReg ? a.lane_rows : bw;
  const int rows = band_lanes * lane_rows;  // rows past bw are zero
  const int qlen = a.probes * bw;

  extern __shared__ int4 smem4[];
  int32_t* s_sig = reinterpret_cast<int32_t*>(smem4);  // [rows][stride]
  int32_t* s_bias = s_sig + rows * stride;              // [tile]
  int32_t* s_q = s_bias + tile;                         // generic: [qlen][kQStride]

  // A warp holds 32 / lanes groups of `lanes` threads, one group per QT
  // queries; lanes past the last group compute on a clamped query and
  // write nothing.
  const int groups = 32 / lanes;
  const int lane = threadIdx.x % 32;
  const int part = lane % lanes;
  const int probe_part = part / band_lanes;  // which P probes of the query
  const int band_part = part % band_lanes;   // which lane_rows band words
  const bool writer = part == 0 && lane / lanes < groups;
  const int qi = ((blockIdx.y * (kThreads / 32) + threadIdx.x / 32) * groups + lane / lanes) *
                 QT;  // first query
  const int32_t* qrow = a.qwords + static_cast<size_t>(min(qi, a.q - 1)) * qlen;

  int32_t qreg[kReg ? U * NQ : 1];
  const int32_t* qp = qrow;  // generic: query word i at qp[i * qs]
  int qs = 1;
  if constexpr (kReg) {
    const int r0 = band_part * lane_rows;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t* src = a.qwords + static_cast<size_t>(min(qi + u / P, a.q - 1)) * qlen +
                           (probe_part * P + u % P) * bw + r0;
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        qreg[u * NQ + r] = r < lane_rows && r0 + r < bw ? src[r] : 1;  // 1: never a zero row
      }
    }
  } else if (a.q_in_smem) {
    for (int i = 0; i < qlen; ++i) s_q[i * kQStride + threadIdx.x] = qrow[i];
    qp = s_q + threadIdx.x;
    qs = kQStride;
  }
  // This thread's rows: step k of its band lane at s_lane + k * band_lanes * stride.
  const int32_t* s_lane = s_sig + band_part * kStep * stride;

  const int ng = a.c / a.group;
  const int spb = max(kSlotsPerBlock, a.group);
  const int s_begin = blockIdx.x * spb;
  const int s_end = min(a.c, s_begin + spb);
  int run[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) run[j] = INT_MIN;
  for (int t0 = s_begin; t0 < s_end; t0 += tile) {
    const int n = min(tile, s_end - t0);
    __syncthreads();  // every thread is done with the previous tile
    if (threadIdx.x < n) {  // one slot column a thread (tile <= kThreads)
      const int col = threadIdx.x;
      const int32_t* src = a.sig_t + t0 + col;
      // Band lane b's rows b*R .. b*R+R-1 (R = lane_rows) go to shared rows
      // whose steps of 4 interleave with the other band lane's, so the two
      // lanes of a warp read rows kStep * stride words apart, in other banks.
      for (int b = 0; b < band_lanes; ++b) {
        for (int k = 0; k < lane_rows; ++k) {
          const int r = b * lane_rows + k;
          const int row = (k & ~(kStep - 1)) * band_lanes + b * kStep + (k & (kStep - 1));
          s_sig[row * stride + col] = r < bw ? src[static_cast<size_t>(r) * a.c] : 0;
        }
      }
      const int32_t tv = a.tie[t0 + col];
      s_bias[col] = tv >= 0 ? tv : a.dead_bias;
    }
    __syncthreads();

    for (int s = 0; s < n; s += 4) {  // n is a multiple of group, group of 4
      const int4 bias = *reinterpret_cast<const int4*>(s_bias + s);
      int cnt[QT][4] = {};
      if constexpr (kReg) {
#pragma unroll
        for (int k = 0; k < NQ; k += kStep) {
          if (k >= lane_rows) break;
          const int32_t* row = s_lane + k * band_lanes * stride + s;
          int4 v[kStep];  // the step's rows of the quad, loaded together
#pragma unroll
          for (int i = 0; i < kStep; ++i) {
            v[i] = *reinterpret_cast<const int4*>(row + i * stride);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int i = 0; i < kStep; i += W) {
              const int j = u / P;  // the unit's query
              const int32_t q0 = qreg[u * NQ + k + i];
              if constexpr (W == 1) {
                match(cnt[j][0], v[i].x, q0);
                match(cnt[j][1], v[i].y, q0);
                match(cnt[j][2], v[i].z, q0);
                match(cnt[j][3], v[i].w, q0);
              } else {
                const int32_t q1 = qreg[u * NQ + k + i + 1];
                match(cnt[j][0], v[i].x, q0, v[i + 1].x, q1);
                match(cnt[j][1], v[i].y, q0, v[i + 1].y, q1);
                match(cnt[j][2], v[i].z, q0, v[i + 1].z, q1);
                match(cnt[j][3], v[i].w, q0, v[i + 1].w, q1);
              }
            }
          }
        }
        for (int m = 1; m < lanes; m <<= 1) {  // the group's sum, into its part 0
#pragma unroll
          for (int j = 0; j < QT; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int other = __shfl_down_sync(0xffffffffu, cnt[j][i], m);
              if (part + m < lanes) cnt[j][i] += other;
            }
          }
        }
      } else {
        const int nb = bw / a.w;
        for (int b = 0; b < nb; ++b) {
          for (int t = 0; t < a.probes; ++t) {
            bool e0 = true, e1 = true, e2 = true, e3 = true;
            for (int j = 0; j < a.w; ++j) {
              const int r = b * a.w + j;
              const int4 v = *reinterpret_cast<const int4*>(s_sig + r * stride + s);
              const int32_t qv = qp[(t * bw + r) * qs];
              e0 &= v.x == qv;
              e1 &= v.y == qv;
              e2 &= v.z == qv;
              e3 &= v.w == qv;
            }
            cnt[0][0] += e0;
            cnt[0][1] += e1;
            cnt[0][2] += e2;
            cnt[0][3] += e3;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const int k01 = max(cnt[j][0] * a.scale + bias.x, cnt[j][1] * a.scale + bias.y);
        const int k23 = max(cnt[j][2] * a.scale + bias.z, cnt[j][3] * a.scale + bias.w);
        run[j] = max(run[j], max(k01, k23));
      }
      const int last = t0 + s + 3;
      if (((last + 1) & (a.group - 1)) == 0) {  // the quad closed a group
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          if (writer && qi + j < a.q) {
            a.out[static_cast<size_t>(qi + j) * ng + last / a.group] = run[j];
          }
          run[j] = INT_MIN;
        }
      }
    }
  }
}

size_t shared_bytes(int rows, int tile) {
  return (static_cast<size_t>(rows) * (tile + kPad) + tile) * sizeof(int32_t);
}

// One launch per 65,535 blocks of queries (grid.y's limit), so any Q runs.
template <int NQ, int W, int P>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = collision_group_max_kernel<NQ, W, P>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int spb = max(kSlotsPerBlock, a.group);
  const int per_block = kThreads / 32 * (32 / (NQ > 0 ? a.lanes : 1)) * kQueries<NQ, P>;
  const int per_launch = 65535 * per_block;
  for (int q0 = 0; q0 < a.q; q0 += per_launch) {
    Args b = a;
    b.q = min(per_launch, a.q - q0);
    b.qwords += static_cast<size_t>(q0) * a.probes * a.bw;
    b.out += static_cast<size_t>(q0) * (a.c / a.group);
    const dim3 grid((a.c + spb - 1) / spb, (b.q + per_block - 1) / per_block);
    kernel<<<grid, kThreads, smem, stream>>>(b);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int NQ, int W>
int launch_registers(const Args& a, int p, cudaStream_t stream) {
  const size_t smem = shared_bytes(a.band_lanes * a.lane_rows, kTile);
  switch (p) {
    case 1: return launch<NQ, W, 1>(a, smem, stream);
    case 2: return launch<NQ, W, 2>(a, smem, stream);
    case 3: return launch<NQ, W, 3>(a, smem, stream);
    case 4: if constexpr (4 * NQ <= kMaxRegWords) return launch<NQ, W, 4>(a, smem, stream); break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
      c % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const int32_t*>(sig_t), static_cast<const int32_t*>(tie),
         static_cast<const int32_t*>(qwords), static_cast<int32_t*>(out),
         q, c, bw, words, probes, group, scale, -num_bands * scale,
         kTile, 1, 1, bw, 0};
  auto st = static_cast<cudaStream_t>(stream);

  // Registers: W of 1 or 2 and BW <= 64, split over one or two band lanes
  // of at most 32 words; the probes split evenly over the fewest probe
  // lanes that leave at most 4 probes and 96 words a thread.
  if ((words == 1 || words == 2) && bw <= 64) {
    a.band_lanes = bw <= 32 ? 1 : 2;
    const int per_lane = (bw + a.band_lanes - 1) / a.band_lanes;
    a.lane_rows = (per_lane + kStep - 1) / kStep * kStep;
    const int nq = a.lane_rows <= 16 ? 16 : 32;
    const int pmax = min(4, kMaxRegWords / nq);
    for (int probe_lanes = 1; probe_lanes * a.band_lanes <= 32; ++probe_lanes) {
      if (probes % probe_lanes != 0 || probes / probe_lanes > pmax) continue;
      a.lanes = probe_lanes * a.band_lanes;
      const int p = probes / probe_lanes;
      if (words == 1) {
        return nq == 16 ? launch_registers<16, 1>(a, p, st) : launch_registers<32, 1>(a, p, st);
      }
      return nq == 16 ? launch_registers<16, 2>(a, p, st) : launch_registers<32, 2>(a, p, st);
    }
  }

  // Generic: the query words in shared memory where they fit beside a
  // 128-slot tile, else from global memory; the tile halves until the
  // slot words fit.
  a.lanes = a.band_lanes = 1;
  a.lane_rows = bw;
  const size_t qbytes = static_cast<size_t>(probes) * bw * kQStride * sizeof(int32_t);
  size_t smem = shared_bytes(bw, a.tile);
  if (smem + qbytes <= kSmemMax) {
    a.q_in_smem = 1;
    smem += qbytes;
  }
  while (smem > kSmemMax && a.tile > 4) {
    a.tile >>= 1;
    smem = shared_bytes(bw, a.tile);
  }
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return launch<0, 0, 0>(a, smem, st);
}
