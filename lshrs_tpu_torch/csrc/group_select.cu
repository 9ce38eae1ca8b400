// The group selection in one launch: for each row of the (Q, ng) int32
// group maxima that kernels B1, B2 and B3 write, the group indices of its
// m largest keys, (Q, m) int64, in descending key order (equal keys by
// ascending index).
//
// Replaces no TPU kernel: the JAX package selects with lax.top_k /
// approx_max_k (lshrs_tpu/ops/scan.py), plain XLA. It takes the place of
// torch.topk in ops/scan.py::select_top_groups, which stays as its plain
// version (CPU tensors) and as the route past its limit (m > 256).
//
// What bounds it on the H100: the bytes. Each key is read once and
// compared once. At glove100.batch's (10,000, 18,493) that is 0.740 GB,
// ~0.221 ms at 3.35 TB/s; a wiki6m4.batch request's two blocks,
// (10,000, 65,536) and (10,000, 34,464), are 4.00 GB, ~1.19 ms.
// torch.topk's multi-block radix select reads the keys once per 8-bit
// digit and then gathers: ~10x that.
//
// Design: one 256-thread block a row, four a SM (64 registers a
// thread, 40 KB of shared memory a block). The block streams its row
// in tiles of 4,096, four 16-byte loads a thread, the next tile's loads
// in flight while a tile is filtered; a row's unaligned head and tail
// (at most 3 keys each) are peeled and taken by single threads in the
// first tile. Each key is compared with a block-wide
// threshold, and the few that pass go, as distinct 64-bit composites
// (key, then the index reversed), to a list in shared memory, one atomic
// a warp (ballot, warp scan). The first threshold comes from the first
// tile: each warp's ceil(m / 8)-th largest of its threads' maxima, the
// least over the 8 warps, at or under which m keys lie. When the list
// passes 512 entries an exact radix select (8-bit digits of the
// composite, the Pick pattern of hamming_refine_topk.cu) keeps its m
// largest and raises the threshold to the m-th, so after the first tile
// almost every key fails one compare and the kernel runs at the speed of
// the read. At the end of the row the list's entries rank each other (an
// exact select first past 256 of them) and the m best are written in
// order. The composites are distinct, so the set is exact: the m largest
// keys, and among equal keys at the m-th the lowest indices.
//
// Rows are not cut into slices for small Q: on the H100 one block a row
// selects (Q, 18,493..65,536) at Q = 1..100 in 18-33 us back to back,
// launch included, no slower than slices merged by an atomic ticket.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                    // 16-byte loads a thread a tile
constexpr int kTileVec = kThreads * kVec;  // ... a block
constexpr int kTile = 4 * kTileVec;        // keys a tile: 4,096
constexpr int kMaxM = 256;                 // the wrapper's limit on m
constexpr int kFill = 512;                 // list entries past which it is cut to m
constexpr int kList = kFill + kTile;       // the list's room: 4,608
constexpr unsigned kFull = 0xffffffffu;

struct Pick {
  int bin;    // the bin holding the needed entry
  int above;  // entries in the bins above it
  int count;  // entries in it
};

struct Shared {
  unsigned long long list[kList];
  unsigned long long keep[kMaxM];
  int hist[kThreads];  // one bin a thread: 8-bit digits
  int warp_sum[kWarps];
  unsigned warp_rth[kWarps];
  int warp_ok[kWarps];
  Pick pick;
  int count;  // entries in the list
  int nkeep;
  unsigned long long floor;  // the list takes composites above it
};

// Orders as (key, -index): larger means a larger key, or the same key at a
// lower index. Never 0 (index < 2^31).
__device__ __forceinline__ unsigned long long compose(int key, unsigned idx) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
         (0xffffffffu - idx);
}

__device__ __forceinline__ int floor_key(unsigned long long floor) {
  return static_cast<int>(static_cast<unsigned>(floor >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int max4(int4 v) { return max(max(v.x, v.y), max(v.z, v.w)); }

// Warp-collective: reserves cnt list entries for each lane, one atomic a
// warp, and returns the lane's first; `over` is set on the lane that sees
// the list pass kFill.
__device__ __forceinline__ int reserve(Shared& s, int cnt, bool& over) {
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  int base = 0;
  if (lane == 31) {
    base = atomicAdd(&s.count, incl);
    over = over || base + incl > kFill;
  }
  return __shfl_sync(kFull, base, 31) + incl - cnt;
}

// Warp-collective: appends the keys of v picked by mask (bit j: v's j-th,
// index idx0 + j).
__device__ __forceinline__ void append4(Shared& s, int4 v, unsigned idx0, unsigned mask,
                                        bool& over) {
  if (!__ballot_sync(kFull, mask != 0)) return;
  int at = reserve(s, __popc(mask), over);
  if (mask & 1u) s.list[at++] = compose(v.x, idx0);
  if (mask & 2u) s.list[at++] = compose(v.y, idx0 + 1);
  if (mask & 4u) s.list[at++] = compose(v.z, idx0 + 2);
  if (mask & 8u) s.list[at] = compose(v.w, idx0 + 3);
}

// Warp-collective: appends c where take.
__device__ __forceinline__ void append1(Shared& s, unsigned long long c, bool take, bool& over) {
  if (!__ballot_sync(kFull, take)) return;
  const int at = reserve(s, take ? 1 : 0, over);
  if (take) s.list[at] = c;
}

// The bin b of s.hist with suffix(b + 1) < need <= suffix(b), suffix(b)
// the entries in bins b and up, into s.pick (there is one when the bins
// hold need or more). Starts and ends with every thread at a barrier.
__device__ void pick_bin(Shared& s, int need) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = s.hist[tid];
  int incl = c;  // this bin's and the higher bins' of the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += y;
  }
  if (lane == 0) s.warp_sum[warp] = incl;
  __syncthreads();
  int above = incl - c;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w > warp) above += s.warp_sum[w];
  }
  if (above < need && above + c >= need) {
    s.pick.bin = tid;
    s.pick.above = above;
    s.pick.count = c;
  }
  __syncthreads();
}

// The composite t with exactly `need` of list[0, n) at or above it (the
// composites are distinct; n >= need >= 1): an MSB-first radix select
// over 8-bit digits that stops as soon as the chosen bin holds exactly the
// entries still needed. Block-collective.
__device__ unsigned long long select_threshold(Shared& s, int n, int need) {
  unsigned long long prefix = 0;
  for (int shift = 56;; shift -= 8) {
    s.hist[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned long long c = s.list[i];
      if (shift == 56 || (c >> (shift + 8)) == prefix) {
        atomicAdd(&s.hist[static_cast<int>(c >> shift) & 255], 1);
      }
    }
    __syncthreads();
    pick_bin(s, need);
    const Pick pk = s.pick;
    need -= pk.above;
    prefix = (prefix << 8) | static_cast<unsigned long long>(pk.bin);
    if (need == pk.count || shift == 0) return prefix << shift;
  }
}

// Cuts list[0, n) to its m largest entries and raises the floor to keep
// them alone. Block-collective; ends at a barrier.
__device__ void cut_to(Shared& s, int n, int m) {
  if (threadIdx.x == 0) s.nkeep = 0;
  const unsigned long long t = select_threshold(s, n, m);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned long long c = s.list[i];
    if (c >= t) s.keep[atomicAdd(&s.nkeep, 1)] = c;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) s.list[j] = s.keep[j];
  if (threadIdx.x == 0) {
    s.count = m;
    s.floor = t - 1;  // t >= 1: a composite is never 0
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 4)
group_select_kernel(const int32_t* __restrict__ keys, int64_t* __restrict__ out, int ng,
                    int m) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const int32_t* p = keys + row * ng;
  const int head =
      min(ng, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2));
  const int nvec = (ng - head) >> 2;
  const int tail = ng - head - 4 * nvec;
  const int4* vp = reinterpret_cast<const int4*>(p + head);

  // The peeled keys: the head's, then the tail's, one a thread.
  bool has_extra = false;
  int extra = INT_MIN;
  unsigned extra_idx = 0;
  if (tid < head + tail) {
    const int j = tid < head ? tid : head + 4 * nvec + (tid - head);
    has_extra = true;
    extra = p[j];
    extra_idx = j;
  }
  if (tid == 0) s.count = 0;

  unsigned long long floor = 0;  // take every key until the first tile sets it
  int fkey = INT_MIN;            // keys under it cannot pass
  const int ntiles = max(1, (nvec + kTileVec - 1) / kTileVec);
  // Tile t + 1's loads are in flight while tile t is filtered.
  int4 v[kVec], next[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int vi = tid + u * kThreads;
    next[u] = vi < nvec ? __ldg(vp + vi) : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  }
  for (int t = 0; t < ntiles; ++t) {
    const int v0 = t * kTileVec + tid;
#pragma unroll
    for (int u = 0; u < kVec; ++u) v[u] = next[u];
    if (t + 1 < ntiles) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int vi = v0 + kTileVec + u * kThreads;
        next[u] = vi < nvec ? __ldg(vp + vi) : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
      }
    }
    if (t == 0) {
      // The first floor: each warp's r-th largest thread maximum, r =
      // ceil(m / 8), the least over the warps; r keys of each warp lie at
      // or above it, so m of the block's do.
      bool valid = has_extra;
      int best = extra;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        if (v0 + u * kThreads < nvec) {
          valid = true;
          best = max(best, max4(v[u]));
        }
      }
      const unsigned sv = valid ? static_cast<unsigned>(best) ^ 0x80000000u : 0u;
      const int r = (m + kWarps - 1) / kWarps;
      int gt = 0, ge = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const unsigned o = __shfl_sync(kFull, sv, j);
        gt += o > sv;
        ge += o >= sv;
      }
      const unsigned at = __ballot_sync(kFull, gt < r && ge >= r);
      const unsigned rth = __shfl_sync(kFull, sv, __ffs(at) - 1);
      const int nvalid = __popc(__ballot_sync(kFull, valid));
      if (lane == 0) {
        s.warp_rth[warp] = rth;
        s.warp_ok[warp] = nvalid >= r;
      }
      __syncthreads();
      bool ok = true;
      unsigned least = 0xffffffffu;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ok = ok && s.warp_ok[w];
        least = min(least, s.warp_rth[w]);
      }
      if (ok && least != 0) floor = (static_cast<unsigned long long>(least) << 32) - 1;
      fkey = floor_key(floor);
    }
    bool over = false;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int vi = v0 + u * kThreads;
      const unsigned idx0 = head + 4u * static_cast<unsigned>(vi);
      unsigned mask = 0;
      if (vi < nvec && max4(v[u]) >= fkey) {
        mask = static_cast<unsigned>(compose(v[u].x, idx0) > floor) |
               static_cast<unsigned>(compose(v[u].y, idx0 + 1) > floor) << 1 |
               static_cast<unsigned>(compose(v[u].z, idx0 + 2) > floor) << 2 |
               static_cast<unsigned>(compose(v[u].w, idx0 + 3) > floor) << 3;
      }
      append4(s, v[u], idx0, mask, over);
    }
    if (t == 0) {
      const unsigned long long c = compose(extra, extra_idx);
      append1(s, c, has_extra && c > floor, over);
    }
    if (__syncthreads_or(over)) {
      cut_to(s, s.count, m);
      floor = s.floor;
      fkey = floor_key(floor);
    }
  }
  int cnt = s.count;

  if (cnt > kThreads) {
    cut_to(s, cnt, m);
    cnt = m;
  }
  // Each entry's rank among the others; the m best are written in order.
  if (tid < cnt) {
    const unsigned long long c = s.list[tid];
    int rank = 0;
    for (int j = 0; j < cnt; ++j) rank += s.list[j] > c;
    if (rank < m) out[row * m + rank] = static_cast<int64_t>(0xffffffffu - static_cast<unsigned>(c));
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a launched kernel (or q == 0). The caller
// validates shapes and dtypes; an argument this kernel cannot take (m
// outside 1..min(256, ng), keys not 4-byte aligned) returns
// cudaErrorInvalidValue without launching.
extern "C" int lshrs_group_select(const void* keys, void* out, int q, int ng, int m,
                                  void* stream) {
  if (q < 0 || ng <= 0 || m <= 0 || m > kMaxM || m > ng ||
      reinterpret_cast<uintptr_t>(keys) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q == 0) return static_cast<int>(cudaSuccess);
  group_select_kernel<<<q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int64_t*>(out), ng, m);
  return static_cast<int>(cudaGetLastError());
}
