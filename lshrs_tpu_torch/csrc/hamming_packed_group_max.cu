// Kernel B3: XOR + popcount Hamming over packed words -> packed key -> group max.
//
// Replaces lshrs_tpu/ops/pallas_scan.py::hamming_packed_group_max_keys
// (kernel body _make_hamming_packed_kernel). For each (query, slot):
// ham = sum over the BW words of popc(sig_t[w, slot] ^ qwords[query, w]);
// key = bias - ham * scale, bias = (num_perm + 1) * scale + tie for alive
// slots (tie >= 0) and 0 for dead ones (so a dead key is <= 0, under
// every alive key, which is >= scale); write the max key of each group of
// `group` CONTIGUOUS slots. The alive key equals kernel B2's symmetric
// Hamming key, so both storages select the same groups.
//
// What bounds it on the H100: the popcounts, Q * C * BW of them (5.5e11 at
// Q = 8192, C = 2^22, BW = 16). __popc issues at a quarter of the integer
// add rate, so it, not the XOR or the add, sets the time. Bytes are
// minor: the store (BW * C * 4 bytes, 256 MB at 4M slots) is read once per
// 256 queries, the queries sit in L2, and the output is group times
// smaller than the (Q, C) key matrix, which never leaves registers.
//
// Design (simple first version): a thread owns 4 neighbouring slots and
// keeps their BW words in registers, loaded once as 16-byte column reads,
// so a warp reads each word row coalesced (template instantiations for 16
// and 8 words; a generic instantiation re-reads the words through L1 for
// every query). A block covers 1024 slots and up to 256 queries, staged 32
// at a time in shared memory, where every thread reads the same query word
// (a broadcast). A thread takes the max over its 4 keys; the group max is
// a shuffle reduction over the group / 4 threads that share the group
// (4 to 32, so never across warps). Group maxima collect in shared memory
// and leave as one contiguous row segment per query.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSPT = 4;                   // slots per thread: one int4 per word row
constexpr int kSlots = kThreads * kSPT;   // slots per block
constexpr int kQT = 32;                   // queries per shared-memory tile
constexpr int kQPB = 256;                 // queries per block (grid y)
constexpr int kMaxBW = 64;                // widest query row the tile holds
constexpr int kMinGroup = 16;

template <int BW>
__global__ void __launch_bounds__(kThreads) hamming_packed_group_max_kernel(
    const int32_t* __restrict__ sig_t,   // (bw, c) transposed packed words
    const int32_t* __restrict__ tie,     // (c,) tie key, -1 = dead
    const int32_t* __restrict__ qwords,  // (q, bw) query words
    int32_t* __restrict__ out,           // (q, c / group) group-max keys
    int q, int c, int bw_rt, int group, int scale, int alive_base) {
  constexpr bool kReg = BW > 0;
  const int bw = kReg ? BW : bw_rt;

  __shared__ int32_t s_q[kQT * kMaxBW];
  __shared__ int32_t s_out[kQT * (kSlots / kMinGroup)];

  const int c0 = blockIdx.x * kSlots;
  const int s0 = c0 + threadIdx.x * kSPT;  // this thread's first slot
  const bool has = s0 < c;  // c % 16 == 0: a thread's 4 slots are all in or out

  int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
  if (has) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(tie + s0));
    b0 = t.x >= 0 ? alive_base + t.x : 0;
    b1 = t.y >= 0 ? alive_base + t.y : 0;
    b2 = t.z >= 0 ? alive_base + t.z : 0;
    b3 = t.w >= 0 ? alive_base + t.w : 0;
  }
  int4 sw[kReg ? BW : 1];
  if constexpr (kReg) {
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      sw[w] = has ? __ldg(reinterpret_cast<const int4*>(
                        sig_t + static_cast<size_t>(w) * c + s0))
                  : make_int4(0, 0, 0, 0);
    }
  }

  const int gthreads = group / kSPT;  // threads sharing one group: 4..32
  const int ngb = kSlots / group;     // groups per block
  const int ng = c / group;
  const int g0 = c0 / group;
  const int ngv = min(ngb, ng - g0);  // groups of this block inside the store
  const int q_begin = blockIdx.y * kQPB;
  const int q_end = min(q, q_begin + kQPB);

  for (int qt0 = q_begin; qt0 < q_end; qt0 += kQT) {
    const int nq = min(kQT, q_end - qt0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < nq * bw; idx += kThreads) {
      s_q[idx] = qwords[static_cast<size_t>(qt0) * bw + idx];
    }
    __syncthreads();
    for (int j = 0; j < nq; ++j) {
      const int32_t* qv = s_q + j * bw;
      int h0 = 0, h1 = 0, h2 = 0, h3 = 0;
      if constexpr (kReg) {
#pragma unroll
        for (int w = 0; w < BW; ++w) {
          const int x = qv[w];
          h0 += __popc(sw[w].x ^ x);
          h1 += __popc(sw[w].y ^ x);
          h2 += __popc(sw[w].z ^ x);
          h3 += __popc(sw[w].w ^ x);
        }
      } else if (has) {
        for (int w = 0; w < bw; ++w) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(
              sig_t + static_cast<size_t>(w) * c + s0));
          const int x = qv[w];
          h0 += __popc(v.x ^ x);
          h1 += __popc(v.y ^ x);
          h2 += __popc(v.z ^ x);
          h3 += __popc(v.w ^ x);
        }
      }
      int m = INT_MIN;
      if (has) {
        m = max(max(b0 - h0 * scale, b1 - h1 * scale),
                max(b2 - h2 * scale, b3 - h3 * scale));
      }
      for (int lane = gthreads >> 1; lane > 0; lane >>= 1) {
        m = max(m, __shfl_xor_sync(0xffffffffu, m, lane));
      }
      if ((threadIdx.x & (gthreads - 1)) == 0) {
        s_out[j * ngb + threadIdx.x / gthreads] = m;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * ngb; idx += kThreads) {
      const int j = idx / ngb;
      const int g = idx - j * ngb;
      if (g < ngv) out[static_cast<size_t>(qt0 + j) * ng + g0 + g] = s_out[idx];
    }
  }
}

template <int BW>
int launch(const int32_t* sig_t, const int32_t* tie, const int32_t* qwords,
           int32_t* out, int q, int c, int bw, int group, int scale,
           int alive_base, cudaStream_t stream) {
  const dim3 grid((c + kSlots - 1) / kSlots, (q + kQPB - 1) / kQPB);
  hamming_packed_group_max_kernel<BW><<<grid, kThreads, 0, stream>>>(
      sig_t, tie, qwords, out, q, c, bw, group, scale, alive_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 on a launched kernel. The caller validates
// shapes and 16-byte alignment; an argument this kernel cannot take (more
// than 64 words, group outside {16, 32, 64, 128}, C not a multiple of
// group) returns cudaErrorInvalidValue without launching.
extern "C" int lshrs_hamming_packed_group_max(const void* sig_t,
                                              const void* tie,
                                              const void* qwords, void* out,
                                              int q, int c, int bw, int group,
                                              int scale, int num_perm,
                                              void* stream) {
  if (q <= 0 || c <= 0 || bw <= 0 || bw > kMaxBW || num_perm <= 0 ||
      (group != 16 && group != 32 && group != 64 && group != 128) ||
      c % group != 0 || q > 65535 * kQPB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int alive_base = (num_perm + 1) * scale;
  const auto* s = static_cast<const int32_t*>(sig_t);
  const auto* t = static_cast<const int32_t*>(tie);
  const auto* qw = static_cast<const int32_t*>(qwords);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bw) {
    case 16:
      return launch<16>(s, t, qw, o, q, c, bw, group, scale, alive_base, st);
    case 8:
      return launch<8>(s, t, qw, o, q, c, bw, group, scale, alive_base, st);
    default:
      return launch<0>(s, t, qw, o, q, c, bw, group, scale, alive_base, st);
  }
}
