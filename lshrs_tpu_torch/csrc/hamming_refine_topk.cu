// The Hamming tail's refine and exact top-k in one launch: gather the
// selected groups' rows of the grouped refine table, XOR-popcount them
// against the query, key each candidate by (hamming asc, id asc) and write
// the query's top-k.
//
// Replaces the plain tail of ops/hamming.py (hamming_refine_gather,
// refine_hamming, hamming_final_topk; their composition is
// hamming_refine_topk_ref). For query qi and each of its m selected groups
// g = groups[qi, j], row g of the table holds `group` slots WORD-MAJOR:
// nw columns of `group` words, then the tie column, then the id column
// (ops/scan.py::build_grouped_refine_rows). A candidate's distance is
// h = sum over the nw words of popc(word ^ qwords[qi, w]) and its key
// scaled * 2^tie_bits + tie with scaled = p + 1 - h, tie >= 0; a dead slot
// (tie -1) keys 0 in the plain tail and never reaches the answer. The
// output is the keys' top-k in descending order, (hamming (Q, k), ids
// (Q, k)) int32; entries past the alive candidates carry hamming p + 1 and
// id -1. Alive ties are distinct id ranks below 2^tie_bits, so alive keys
// are distinct and the order is torch.topk's: the answer is the plain
// tail's bit for bit, in 64-bit keys at every scale.
//
// What bounds it on the H100: the bytes. Each candidate reads its nw
// words and its tie (the id only when it is picked): at the cells' shape
// (Q = 10,000, m = 10, group 64, nw = 8) 10,000 x 640 x 9 x 4 = 230 MB,
// ~0.069 ms at 3.35 TB/s. The popcounts (Q m group nw of them) and the
// selection are a few thousand warp instructions a query. On an H100
// (80GB HBM3, 700 W) it takes ~0.079 ms there, 88% of that bound
// (benchmarks/torch_refine_probe.py); ptxas: 48 registers a thread, no
// spills.
//
// Design: one 128-thread block per query. Each thread takes four adjacent
// slots of a row at a time and loads each of their word columns, and
// their ties, as one 16-byte vector, so a warp reads 512 contiguous bytes
// of a column; the popcounts stay in registers and the 64-bit keys go to
// shared memory (m * group of them, dead and empty ones as -1). The exact
// k-th largest key is found by radix selection over the keys in shared
// memory: a histogram of `scaled` (hist_bins >= p + 2 bins), then 8-bit
// digits of the tie among the keys that share the chosen prefix, stopping
// as soon as the chosen bin holds exactly the keys still needed. The keys
// at or above that threshold (min(k, alive) of them) are compacted, ranked
// against each other and written in order; only the picked candidates'
// ids are read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;      // the wrapper's limit on k
constexpr int kMaxWords = 64;   // ... on nw
constexpr int kMaxCands = 8192; // ... on m * group
constexpr int kDigitBins = 256; // bins of the tie passes (8-bit digits)

struct Pick {
  int bin;    // the bin holding the needed key
  int above;  // keys in the bins above it
  int count;  // keys in it
  int total;  // keys in every bin
};

// The key of one candidate, or -1 where the plain tail's key is under
// 2^tie_bits (a dead slot: it takes no place in the answer).
__device__ __forceinline__ long long refine_key(int h, int tie, int p, int tie_bits) {
  const int scaled = p + 1 - h;
  if (tie < 0 || scaled <= 0) return -1;
  return (static_cast<long long>(scaled) << tie_bits) + tie;
}

// The bin b of hist[0, nbins) with suffix(b + 1) < need <= suffix(b),
// suffix(b) the keys in bins b and up, into *out (with the total; no bin
// when the total is under need). nbins is a multiple of kThreads.
// Starts and ends with every thread at a barrier.
__device__ void pick_bin(const int* hist, int nbins, int need, int* warp_sum, Pick* out) {
  const int per = nbins / kThreads;
  const int lo = threadIdx.x * per;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int local = 0;
  for (int j = 0; j < per; ++j) local += hist[lo + j];
  int incl = local;  // this lane's and the higher lanes' keys
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  if (lane == 0) warp_sum[warp] = incl;
  __syncthreads();
  int running = incl - local;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sum[w];
    total += s;
    if (w > warp) running += s;
  }
  if (threadIdx.x == 0) out->total = total;
  if (running < need && running + local >= need) {
    for (int j = per - 1; j >= 0; --j) {
      const int c = hist[lo + j];
      if (running + c >= need) {
        out->bin = lo + j;
        out->above = running;
        out->count = c;
        break;
      }
      running += c;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
hamming_refine_topk_kernel(const int32_t* __restrict__ rows, const int64_t* __restrict__ groups,
                           const int32_t* __restrict__ qwords, int32_t* __restrict__ out_h,
                           int32_t* __restrict__ out_ids, int m, int nw, int group, int k, int p,
                           int tie_bits, int hist_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = m * group;
  long long* keys = reinterpret_cast<long long*>(smem);
  int* hist = reinterpret_cast<int*>(keys + n);
  __shared__ int qs[kMaxWords];
  __shared__ long long sel_key[kMaxK];
  __shared__ int sel_pos[kMaxK];
  __shared__ int warp_sum[kWarps];
  __shared__ Pick pick;
  __shared__ int nsel;

  const long long qi = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < nw) qs[tid] = qwords[qi * nw + tid];
  if (tid == 0) nsel = 0;
  __syncthreads();

  // 1. Distances and keys, four adjacent slots a thread.
  const int64_t* qgroups = groups + qi * m;
  const long long row_len = static_cast<long long>(nw + 2) * group;
  const int group_shift = __ffs(group) - 1;
  const int quad_shift = group_shift - 2;
  for (int qd = tid; qd < (n >> 2); qd += kThreads) {
    const int r = qd >> quad_shift;
    const int s = (qd - (r << quad_shift)) << 2;
    const int32_t* base = rows + qgroups[r] * row_len + s;
    const int4 t = __ldg(reinterpret_cast<const int4*>(base + nw * group));
    int h0 = 0, h1 = 0, h2 = 0, h3 = 0;
#pragma unroll 8
    for (int w = 0; w < nw; ++w) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(base + w * group));
      const int x = qs[w];
      h0 += __popc(v.x ^ x);
      h1 += __popc(v.y ^ x);
      h2 += __popc(v.z ^ x);
      h3 += __popc(v.w ^ x);
    }
    long long* kq = keys + (r << group_shift) + s;
    kq[0] = refine_key(h0, t.x, p, tie_bits);
    kq[1] = refine_key(h1, t.y, p, tie_bits);
    kq[2] = refine_key(h2, t.z, p, tie_bits);
    kq[3] = refine_key(h3, t.w, p, tie_bits);
  }
  for (int j = tid; j < hist_bins; j += kThreads) hist[j] = 0;
  __syncthreads();

  // 2. The threshold: the k-th largest key, or 0 (every alive key) when
  // at most k are alive. First by `scaled`, the key's bits from tie_bits.
  for (int i = tid; i < n; i += kThreads) {
    const long long key = keys[i];
    if (key >= 0) atomicAdd(&hist[key >> tie_bits], 1);
  }
  __syncthreads();
  pick_bin(hist, hist_bins, k, warp_sum, &pick);
  long long thresh = 0;
  if (pick.total > k) {
    long long prefix = pick.bin;
    int need = k - pick.above;
    bool done = need == pick.count;
    int shift = tie_bits;
    // Then the tie, 8 bits at a time, among the keys under the prefix.
    while (!done && shift > 0) {
      const int w = shift < 8 ? shift : 8;
      shift -= w;
      for (int j = tid; j < kDigitBins; j += kThreads) hist[j] = 0;
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const long long key = keys[i];
        if (key >= 0 && (key >> (shift + w)) == prefix) {
          atomicAdd(&hist[static_cast<int>(key >> shift) & ((1 << w) - 1)], 1);
        }
      }
      __syncthreads();
      pick_bin(hist, kDigitBins, need, warp_sum, &pick);
      need -= pick.above;
      prefix = (prefix << w) | pick.bin;
      done = need == pick.count;
    }
    thresh = prefix << shift;
  }

  // 3. The keys at or above it, in any order, then each one's rank.
  for (int i = tid; i < n; i += kThreads) {
    const long long key = keys[i];
    if (key >= thresh) {
      const int at = atomicAdd(&nsel, 1);
      if (at < k) {
        sel_key[at] = key;
        sel_pos[at] = i;
      }
    }
  }
  __syncthreads();
  const int got = min(nsel, k);
  const long long o = qi * k;
  for (int j = tid; j < k; j += kThreads) {
    if (j < got) {
      const long long key = sel_key[j];
      int rank = 0;
      for (int l = 0; l < got; ++l) {
        const long long x = sel_key[l];
        rank += (x > key) || (x == key && l < j);
      }
      const int pos = sel_pos[j];
      const int r = pos >> group_shift;
      const int s = pos & (group - 1);
      out_h[o + rank] = p + 1 - static_cast<int>(key >> tie_bits);
      out_ids[o + rank] = rows[qgroups[r] * row_len + static_cast<long long>(nw + 1) * group + s];
    } else {
      out_h[o + j] = p + 1;
      out_ids[o + j] = -1;
    }
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a launched kernel (or q == 0). The caller
// validates shapes and dtypes; an argument this kernel cannot take (group
// outside {16, 32, 64, 128}, nw outside 1..64, k outside 1..128, m * group
// past 8,192, p + 2 past 4,096 bins, tie_bits outside 1..40, a table not
// 16-byte aligned) returns cudaErrorInvalidValue without launching.
extern "C" int lshrs_hamming_refine_topk(const void* rows, const void* groups, const void* qwords,
                                         void* out_h, void* out_ids, int q, int m, int nw,
                                         int group, int k, int p, int tie_bits, void* stream) {
  if (q < 0 || m <= 0 || nw <= 0 || nw > kMaxWords || k <= 0 || k > kMaxK || p <= 0 ||
      p + 2 > 4096 || tie_bits <= 0 || tie_bits > 40 ||
      (group != 16 && group != 32 && group != 64 && group != 128) || m * group > kMaxCands ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q == 0) return static_cast<int>(cudaSuccess);
  int hist_bins = kDigitBins;
  while (hist_bins < p + 2) hist_bins <<= 1;
  const int smem = m * group * 8 + hist_bins * 4;
  if (smem > 48 * 1024) {  // past the default: opt in, on the current device
    const cudaError_t e = cudaFuncSetAttribute(
        hamming_refine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hamming_refine_topk_kernel<<<q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int64_t*>(groups),
      static_cast<const int32_t*>(qwords), static_cast<int32_t*>(out_h),
      static_cast<int32_t*>(out_ids), m, nw, group, k, p, tie_bits, hist_bins);
  return static_cast<int>(cudaGetLastError());
}
