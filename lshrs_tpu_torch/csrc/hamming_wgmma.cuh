// The int8 tensor-core pipeline shared by kernels B2 (hamming_group_max.cu)
// and B3 (hamming_packed_group_max.cu): 64-query tiles stream past resident
// 256-slot tiles of +-1 int8 operands, the m64n256k32 wgmma products
// become packed (scaled dot, tie) keys, and each group of `G` contiguous
// slots leaves as its max key. hamming_group_max.cu describes the design
// and what bounds it; the two kernels differ only in where a slot tile's
// +-1 operand comes from (the template argument kPacked):
//
//   B2 (kPacked = false): the store's bitplanes (C, pp), loaded by TMA;
//   B3 (kPacked = true):  the store's packed words (BW, C) int32, rows ld
//     int32 apart (a block or live prefix of a wider store). Two slot
//     producer warps load a tile's BW x 256 words by TMA into a staging
//     buffer, expand column j = w * word_bits + b of each slot to +1 where
//     bit b of word w is set and -1 where it is clear (zero past
//     BW * word_bits), and write the tile in the K-major 128-byte-swizzled
//     layout the TMA gives B2's planes: row r's 16-byte chunk c at
//     r * 128 + ((c ^ (r % 8)) * 16) within each 128-column k-block. The
//     expansion runs once per slot tile, into the buffer the next tile's
//     planes would be prefetched into, so it is amortised over every query
//     tile. Where the expanded tile does not fit resident (K past 640
//     bytes), each query producer warp expands the slot k-block into its
//     stage beside the query k-block instead, from the words in L2.
//
// Both kernels' keys are ((dot + offset) >> shift) * scale + bias, bias =
// tie + scale for alive slots and dead_bias for dead ones.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;          // queries per tile (one wgmma M)
constexpr int kBN = 256;         // slots per tile (one wgmma N)
constexpr int kKB = 128;         // bytes per k-block (the 128-byte swizzle span)
constexpr int kThreads = 352;    // two consumer warpgroups + three producer warps
constexpr int kPackedThreads = 384;  // B3: a second slot-tile producer warp (168 registers still fit)
constexpr int kExpandWarps = 2;      // B3: the slot-tile producer warps that expand words
constexpr int kABytes = kBM * kKB;   // 8 KB query k-block
constexpr int kBBytes = kBN * kKB;   // 32 KB slot k-block
constexpr int kSmemMax = 232448;     // the H100's per-block maximum
constexpr int kMaxStages = 8;

struct Params {
  const int32_t* tie;
  int32_t* out;
  int q, c, pp, nkb, nqt, ntiles;
  int stages;       // k-block stages per warpgroup (>= 2)
  int nb;           // resident slot-tile buffers: 0 (streamed), 1 or 2
  int scale, offset, shift, dead_bias;
  uint32_t stage_bytes, stages_off, bias_off, bar_off;
  // B3 only: the (bw, c) packed words, rows ld >= c int32 apart, the low
  // bits used of each word, nbits = bw * wb expanded columns, and where a
  // resident slot tile's words are staged in shared memory.
  const int32_t* words;
  int ld, bw, wb, nbits;
  uint32_t words_off;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait of seconds means a load that never lands: trap (an error the
// launch reports) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row core
// groups 1024 bytes apart (SBO); LBO is unused by this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 256 int32, 128 per thread) (+)= A (64 x 32 s8) . B (256 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The max of 4 groups' partial maxima v[0..3] over the 4 lanes of a quad:
// returns the max of group (lane & 3) in 3 shuffles.
__device__ __forceinline__ int quad_reduce_scatter4(const int (&v)[4], int lane) {
  const bool b0 = lane & 1;
  int k0 = b0 ? v[1] : v[0];
  int k1 = b0 ? v[3] : v[2];
  k0 = max(k0, __shfl_xor_sync(0xffffffffu, b0 ? v[0] : v[1], 1));
  k1 = max(k1, __shfl_xor_sync(0xffffffffu, b0 ? v[2] : v[3], 1));
  const bool b1 = lane & 2;  // k0 holds group b0, k1 group 2 + b0
  const int k = b1 ? k1 : k0;
  return max(k, __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2));
}

// Groups gq * C .. gq * C + C - 1 of a slot tile (C = kChunk): each one's
// max key over this thread's fragment columns, for its two rows, v[r][g].
// Columns 8j + 2 * (lane % 4) + {0, 1} hold acc[4j + 2r + {0, 1}].
template <int G, int kChunk>
__device__ __forceinline__ void chunk_max_keys(const int (&acc)[128], const int2* bias2, int quad,
                                               int gq, int offset, int shift, int scale,
                                               int (&v)[2][kChunk]) {
  constexpr int kJ = G / 8;  // n8 column blocks per group
#pragma unroll
  for (int gc = 0; gc < kChunk; ++gc) {
    int m0 = INT_MIN, m1 = INT_MIN;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int jn = (gq * kChunk + gc) * kJ + jj;
      const int2 b = bias2[4 * jn + quad];
      int d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = (acc[4 * jn + e] + offset) >> shift;
      m0 = __vimax3_s32(m0, d[0] * scale + b.x, d[1] * scale + b.y);
      m1 = __vimax3_s32(m1, d[2] * scale + b.x, d[3] * scale + b.y);
    }
    v[0][gc] = m0;
    v[1][gc] = m1;
  }
}

// ---- B3's slot source: packed words -> +-1 int8 rows in shared memory ----

// 4 bits -> 4 bytes, bit i -> byte i: 0x01 (+1) where set, 0xFF (-1) where
// clear. The multiply spreads the bits 8 apart without carries.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  // ~(x * 0xFE) as one multiply-add: x * -0xFE - 1.
  return ((nib * 0x00204081u) & 0x01010101u) * 0xFFFFFF02u + 0xFFFFFFFFu;
}

// No "memory" clobber, so the compiler may hoist the next chunks' loads
// above it: nothing reads these bytes back before fence_proxy_async and
// the mbarrier arrive, which are ordered after every store.
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

// Makes this thread's shared-memory stores visible to the async proxy
// (wgmma reads its operands through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Columns 16 g .. 16 g + 15 of one slot's +-1 row: column j is bit j % wb
// of word j / wb, read by word(w); zero from column nbits = bw * wb on.
// WB is wb where it is 8, 16 or 32 (one or two words per chunk), else 0;
// kInside: the chunk is known to end inside the signature.
template <int WB, bool kInside, class Word>
__device__ __forceinline__ uint4 expand_chunk(const Word& word, int g, int bw, int wb, int nbits) {
  const int nv = kInside ? 16 : nbits - 16 * g;  // columns inside the signature
  if (nv <= 0) return make_uint4(0u, 0u, 0u, 0u);
  uint32_t v;
  if constexpr (WB == 16) {
    v = word(g) & 0xFFFFu;
  } else if constexpr (WB == 32) {
    v = (word(g >> 1) >> ((g & 1) * 16)) & 0xFFFFu;
  } else if constexpr (WB == 8) {
    v = word(2 * g) & 0xFFu;
    if (kInside || 2 * g + 1 < bw) v |= (word(2 * g + 1) & 0xFFu) << 8;
  } else {
    v = 0;
    int col = 16 * g;
    for (int i = 0; i < 16 && col < nbits;) {
      const int w = col / wb;
      const int off = col - w * wb;
      const int take = min(wb - off, 16 - i);
      v |= ((word(w) >> off) & ((1u << take) - 1u)) << i;
      i += take;
      col += take;
    }
  }
  uint4 x = make_uint4(spread4(v & 15u), spread4((v >> 4) & 15u), spread4((v >> 8) & 15u),
                       spread4(v >> 12));
  if (!kInside && nv < 16) {  // the signature ends inside this chunk
    auto keep = [nv](int j) {
      const int n = nv - 4 * j;
      return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
    };
    x.x &= keep(0);
    x.y &= keep(1);
    x.z &= keep(2);
    x.w &= keep(3);
  }
  return x;
}

// k-blocks kb0 .. kb0 + nk - 1 of a 256-slot tile's +-1 rows, rows
// row0 + lane, row0 + lane + step, ...: k-block kb0 + i at
// dst + i * kBBytes, row r's chunk c at
// r * 128 + ((c ^ (r % 8)) * 16), the layout a 128-byte-swizzled TMA box
// has and smem_desc describes. word(r, w) reads word w of the tile's row r.
// A row's 8 chunks of a k-block are computed before they are stored, so
// their loads overlap. A warp's 16-byte stores for one chunk cover 8
// distinct 16-byte bank groups per 8 rows, so they are free of bank
// conflicts.
template <int WB, class Word>
__device__ __forceinline__ void expand_rows(uint32_t dst, int kb0, int nk, int row0, int step,
                                            const Params& prm, const Word& word) {
  constexpr int kChunks = kKB / 16;
  for (int r = row0; r < kBN; r += step) {
    auto row_word = [&](int w) { return word(r, w); };
    const uint32_t row = dst + static_cast<uint32_t>(r * kKB);
    for (int kk = 0; kk < nk; ++kk) {
      const int g0 = (kb0 + kk) * kChunks;
      uint4 x[kChunks];
      if ((g0 + kChunks) * 16 <= prm.nbits) {  // a k-block inside the signature
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          x[c] = expand_chunk<WB, true>(row_word, g0 + c, prm.bw, prm.wb, prm.nbits);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          x[c] = expand_chunk<WB, false>(row_word, g0 + c, prm.bw, prm.wb, prm.nbits);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        st_shared_v4(row + static_cast<uint32_t>(kk * kBBytes + ((c ^ (r & 7)) << 4)), x[c]);
      }
    }
  }
}

template <class Word>
__device__ __forceinline__ void expand_tile(uint32_t dst, int kb0, int nk, int row0, int step,
                                            const Params& prm, const Word& word) {
  switch (prm.wb) {
    case 16:
      expand_rows<16>(dst, kb0, nk, row0, step, prm, word);
      break;
    case 8:
      expand_rows<8>(dst, kb0, nk, row0, step, prm, word);
      break;
    case 32:
      expand_rows<32>(dst, kb0, nk, row0, step, prm, word);
      break;
    default:
      expand_rows<0>(dst, kb0, nk, row0, step, prm, word);
  }
}

template <int G, bool kPacked>
__global__ void __launch_bounds__(kPacked ? kPackedThreads : kThreads, 1) hamming_group_max_kernel(
    const __grid_constant__ CUtensorMap qmap,   // query operand (q, pp) int8, box 128 x 64
    const __grid_constant__ CUtensorMap smap,   // B2: planes (c, pp) int8, box 128 x 256;
                                                // B3: words (bw, c) int32, box 256 x bw
    const Params prm) {
  static_assert(G >= 16 && kBN % G == 0, "group must divide the slot tile");
  constexpr int kGroups = kBN / G;                   // groups per slot tile
  constexpr int kChunk = kGroups >= 4 ? 4 : kGroups; // groups reduced together

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  int32_t* const s_bias = reinterpret_cast<int32_t*>(gbase + prm.bias_off);  // [nbuf][kBN]
  // Barriers: full[2][stages] and empty[2][stages] (query k-blocks), then
  // tile_full[2] and tile_empty[2] (a slot tile's biases, and its planes
  // when resident), then (B3) words_full (a slot tile's staged words).
  const uint32_t bars = base + prm.bar_off;

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: consumer warpgroups; 2: producer warps
  const int t128 = tid % 128;
  const int warp = t128 / 32;
  const int lane = tid % 32;
  const int quad = lane & 3;
  const bool resident = prm.nb > 0;
  const int nbuf = resident ? prm.nb : 2;
  const int D = prm.stages;
  const int nkb = prm.nkb;
  const int nqt = prm.nqt;
  const int nt = (prm.ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  // The block's (slot tile, query tile) pairs k = j * nqt + qt, in order;
  // warpgroup w takes k = w, w + 2, ... and the two alternate at the
  // tensor cores.
  const int K = nt * nqt;

  auto full_bar = [&](int w, int s) { return bars + 8u * (w * D + s); };
  auto empty_bar = [&](int w, int s) { return bars + 8u * (2 * D + w * D + s); };
  auto tile_full = [&](int b) { return bars + 8u * (4 * D + b); };
  auto tile_empty = [&](int b) { return bars + 8u * (4 * D + 2 + b); };
  auto stage_addr = [&](int w, int s) {
    return base + prm.stages_off + prm.stage_bytes * static_cast<uint32_t>(w * D + s);
  };
  auto slot_tile = [&](int j) {
    return static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 * D; ++i) {
      // full: the producer's expect_tx (B3 streamed: and the other 31
      // lanes of its warp, which write the stage's slot k-block)
      mbar_init(bars + 8u * i, kPacked && !resident ? 32 : 1);
      mbar_init(bars + 8u * (2 * D + i), 128);    // empty: every consumer thread
    }
    for (int b = 0; b < 2; ++b) {
      // the slot-tile producers' lanes (B3 resident: both warps')
      mbar_init(tile_full(b), kPacked && resident ? 32 * kExpandWarps : 32);
      mbar_init(tile_empty(b), 2);  // one per consumer warpgroup
    }
    if constexpr (kPacked) mbar_init(bars + 8u * (4 * D + 4), 1);  // words_full
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    const int pw = t128 / 32;
    if (pw < 2) {
      if constexpr (kPacked) {
        if (!resident) {
          // B3 streamed: the whole warp expands each slot k-block from the
          // words (read through L2) into the stage, then lane 0 adds the
          // query k-block by TMA.
          int n = 0, s = 0, phase = 0;
          for (int k = pw; k < K; k += 2) {
            const int qt = k % nqt;
            const int slot0 = slot_tile(k / nqt) * kBN;
            auto word = [&](int r, int w) -> uint32_t {
              const int slot = slot0 + r;
              return slot < prm.c ? static_cast<uint32_t>(
                                        __ldg(prm.words + static_cast<size_t>(w) * prm.ld + slot))
                                  : 0u;
            };
            for (int kb = 0; kb < nkb; ++kb) {
              if (n++ >= D) mbar_wait(empty_bar(pw, s), static_cast<uint32_t>(phase ^ 1));
              const uint32_t bar = full_bar(pw, s);
              expand_tile(stage_addr(pw, s) + kABytes, kb, 1, lane, 32, prm, word);
              fence_proxy_async();
              __syncwarp();
              if (lane == 0) {
                mbar_expect_tx(bar, kABytes);
                tma_load(stage_addr(pw, s), &qmap, bar, kb * kKB, qt * kBM);
              } else {
                mbar_arrive(bar);
              }
              if (++s == D) {
                s = 0;
                phase ^= 1;
              }
            }
          }
          return;
        }
      }
      // Query producer of warpgroup pw: its k-blocks in order, each into
      // stage m % D once the consumers have released the stage.
      if (lane != 0) return;
      int n = 0, s = 0, phase = 0;
      for (int k = pw; k < K; k += 2) {
        const int qt = k % nqt;
        const int t = slot_tile(k / nqt);
        for (int kb = 0; kb < nkb; ++kb) {
          if (n++ >= D) mbar_wait(empty_bar(pw, s), static_cast<uint32_t>(phase ^ 1));
          const uint32_t bar = full_bar(pw, s);
          mbar_expect_tx(bar, prm.stage_bytes);
          tma_load(stage_addr(pw, s), &qmap, bar, kb * kKB, qt * kBM);
          if (!resident) tma_load(stage_addr(pw, s) + kABytes, &smap, bar, kb * kKB, t * kBN);
          if (++s == D) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    if constexpr (kPacked) {
      if (!resident && pw > 2) return;  // streamed: one slot-tile producer
      if (resident) {
        // B3's slot-tile producers, warps e = 0, 1: tile j's words staged by
        // TMA (tile j + 1's requested once both warps have expanded j), and
        // each warp's half of its biases and of its +-1 rows (rows e * 32 +
        // lane + 64 i), expanded into buffer j % nbuf once both warpgroups
        // have released tile j - nbuf.
        const int e = pw - 2;
        const uint32_t words_full = bars + 8u * (4 * D + 4);
        const uint32_t staged = base + prm.words_off;
        const int32_t* const s_words = reinterpret_cast<const int32_t*>(gbase + prm.words_off);
        const uint32_t wbytes = static_cast<uint32_t>(prm.bw * kBN * 4);
        auto word = [&](int r, int w) { return static_cast<uint32_t>(s_words[w * kBN + r]); };
        if (e == 0 && lane == 0) {
          mbar_expect_tx(words_full, wbytes);
          tma_load(staged, &smap, words_full, slot_tile(0) * kBN, 0);
        }
        for (int j = 0; j < nt; ++j) {
          const int b = j % nbuf;
          if (j >= nbuf) mbar_wait(tile_empty(b), static_cast<uint32_t>((j / nbuf - 1) & 1));
          for (int i = 32 * e + lane; i < kBN; i += 32 * kExpandWarps) {
            const int slot = slot_tile(j) * kBN + i;
            const int32_t tv = slot < prm.c ? prm.tie[slot] : -1;
            s_bias[b * kBN + i] = tv >= 0 ? tv + prm.scale : prm.dead_bias;
          }
          mbar_wait(words_full, static_cast<uint32_t>(j & 1));
          expand_tile(base + static_cast<uint32_t>(b * nkb * kBBytes), 0, nkb, 32 * e + lane,
                      32 * kExpandWarps, prm, word);
          fence_proxy_async();
          // Both warps have read the staged words (named barrier 5; the
          // consumers use 1-4).
          asm volatile("bar.sync 5, %0;" ::"n"(32 * kExpandWarps) : "memory");
          if (e == 0 && lane == 0 && j + 1 < nt) {
            mbar_expect_tx(words_full, wbytes);
            tma_load(staged, &smap, words_full, slot_tile(j + 1) * kBN, 0);
          }
          mbar_arrive(tile_full(b));
        }
        return;
      }
    }
    // Slot-tile producer: tile j's biases (and resident planes) into
    // buffer j % nbuf once both warpgroups have released tile j - nbuf.
    for (int j = 0; j < nt; ++j) {
      const int b = j % nbuf;
      if (j >= nbuf) mbar_wait(tile_empty(b), static_cast<uint32_t>((j / nbuf - 1) & 1));
      for (int i = lane; i < kBN; i += 32) {
        const int slot = slot_tile(j) * kBN + i;
        const int32_t tv = slot < prm.c ? prm.tie[slot] : -1;
        s_bias[b * kBN + i] = tv >= 0 ? tv + prm.scale : prm.dead_bias;
      }
      if (lane == 0 && resident) {
        mbar_expect_tx(tile_full(b), static_cast<uint32_t>(nkb * kBBytes));
        for (int kb = 0; kb < nkb; ++kb) {
          tma_load(base + static_cast<uint32_t>((b * nkb + kb) * kBBytes), &smap, tile_full(b),
                   kb * kKB, slot_tile(j) * kBN);
        }
      } else {
        mbar_arrive(tile_full(b));
      }
    }
    return;
  }

  int waited = -1;    // the last slot tile whose buffer this warpgroup has seen filled
  int released = 0;   // slot tiles < released are released by this warpgroup
  auto wait_tile = [&](int j) {
    mbar_wait(tile_full(j % nbuf), static_cast<uint32_t>((j / nbuf) & 1));
    waited = j;
  };
  // Release slot tiles up to nj (exclusive) once every thread of the
  // warpgroup is done with them; a tile it had no query tile in is first
  // seen filled, so no barrier runs more than one phase ahead of its waiter.
  auto release_to = [&](int nj) {
    if (released >= nj) return;
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    for (int jj = released; jj < nj; ++jj) {
      if (jj > waited) wait_tile(jj);
      if (t128 == 0) mbar_arrive(tile_empty(jj % nbuf));
    }
    released = nj;
  };
  release_to(wg < K ? wg / nqt : nt);

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  const int ng = prm.c / G;
  int s = 0, phase = 0;  // the next query stage and its fill parity
  for (int k = wg; k < K; k += 2) {
    const int j = k / nqt;
    const int qt = k % nqt;
    const int b = j % nbuf;
    if (j > waited) wait_tile(j);
    const uint32_t planes_base = base + static_cast<uint32_t>(b * nkb * kBBytes);
    // My turn at the tensor cores: the other warpgroup has issued its tile
    // k - 1, and runs that tile's epilogue while this one multiplies.
    if (k > 0) asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
    int prev = -1;  // the stage of the previous k-block, released after it is read
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full_bar(wg, s), static_cast<uint32_t>(phase));
      const uint32_t a_addr = stage_addr(wg, s);
      const uint32_t b_addr =
          resident ? planes_base + static_cast<uint32_t>(kb * kBBytes) : a_addr + kABytes;
      wgmma_fence();
      // Every k-step of the k-block, past pp too: TMA zero-filled those
      // columns (a branch here would serialise the wgmmas).
#pragma unroll
      for (int ks = 0; ks < kKB / 32; ++ks) {
        wgmma_s8(acc, smem_desc(a_addr + ks * 32), smem_desc(b_addr + ks * 32), (kb | ks) != 0);
      }
      wgmma_commit();
      if (kb == nkb - 1 && k + 1 < K) {
        asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");
      }
      if (prev >= 0) {
        wgmma_wait<1>();  // the previous k-block has been read
        mbar_arrive(empty_bar(wg, prev));
      }
      prev = s;
      if (++s == D) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty_bar(wg, prev));

    // Epilogue: keys, then the max of each contiguous group, kChunk
    // groups at a time.
    const int2* bias2 = reinterpret_cast<const int2*>(s_bias + b * kBN);
    const int row0 = qt * kBM + warp * 16 + (lane >> 2);
    const int g0 = slot_tile(j) * kGroups;
#pragma unroll
    for (int gq = 0; gq < kGroups / kChunk; ++gq) {
      int v[2][kChunk];
      chunk_max_keys<G, kChunk>(acc, bias2, quad, gq, prm.offset, prm.shift, prm.scale, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        int32_t* const orow = prm.out + static_cast<size_t>(row) * ng;
        if constexpr (kChunk == 4) {
          const int best = quad_reduce_scatter4(v[r], lane);
          const int g = g0 + 4 * gq + quad;
          if (row < prm.q && g < ng) orow[g] = best;
        } else {
#pragma unroll
          for (int gc = 0; gc < kChunk; ++gc) {
            int best = v[r][gc];
            best = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
            best = max(best, __shfl_xor_sync(0xffffffffu, best, 2));
            const int g = g0 + gq * kChunk + gc;
            if (quad == gc && row < prm.q && g < ng) orow[g] = best;
          }
        }
      }
    }
    release_to(k + 2 < K ? (k + 2) / nqt : nt);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, pp) int8 matrix as 128-byte x box_rows TMA boxes with
// the 128-byte swizzle; out-of-range rows and columns read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int pp, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(pp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pp)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKB), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory: [resident slot tiles nb x nkb x 32 KB][B3: staged words
// bw x 1 KB][2 x stages][bias 2 x 1 KB][barriers], plus 1 KB to align the
// base. Prefers two resident buffers (the next slot tile prefetched), then
// one, then streaming. Fills prm's layout and returns the bytes.
int plan_smem(Params& prm, bool packed) {
  const int nbars = 4 + (packed ? 1 : 0);  // besides the 4 per stage
  const int fixed = 1024 + 2 * kBN * 4 + (4 * kMaxStages + nbars) * 8;
  const int avail = kSmemMax - fixed;
  const int plane_tile = prm.nkb * kBBytes;
  const int staged = packed ? prm.bw * kBN * 4 : 0;
  int nb = 0, stages = 0;
  for (int b = 2; b >= 1 && nb == 0; --b) {
    const int s = (avail - b * plane_tile - staged) / (2 * kABytes);
    if (s >= 2) {
      nb = b;
      stages = s < kMaxStages ? s : kMaxStages;
    }
  }
  prm.stage_bytes = kABytes;
  if (nb == 0) {
    prm.stage_bytes = kABytes + kBBytes;
    stages = avail / (2 * static_cast<int>(prm.stage_bytes));
    if (stages > kMaxStages) stages = kMaxStages;
  }
  prm.nb = nb;
  prm.stages = stages;
  prm.words_off = static_cast<uint32_t>(nb * plane_tile);
  prm.stages_off = prm.words_off + static_cast<uint32_t>(nb > 0 ? staged : 0);
  prm.bias_off = prm.stages_off + 2u * stages * prm.stage_bytes;
  prm.bar_off = prm.bias_off + 2u * kBN * 4u;
  return static_cast<int>(prm.bar_off) + (4 * stages + nbars) * 8 + 1024;
}

template <int G, bool kPacked>
int launch(const CUtensorMap& qmap, const CUtensorMap& smap, const Params& prm, int smem,
           cudaStream_t stream) {
  constexpr int threads = kPacked ? kPackedThreads : kThreads;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(hamming_group_max_kernel<G, kPacked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = prm.ntiles < sms ? prm.ntiles : sms;
  hamming_group_max_kernel<G, kPacked><<<grid, threads, smem, stream>>>(qmap, smap, prm);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked>
int launch_group(int group, const CUtensorMap& qmap, const CUtensorMap& smap, const Params& prm,
                 int smem, cudaStream_t stream) {
  switch (group) {
    case 16:
      return launch<16, kPacked>(qmap, smap, prm, smem, stream);
    case 32:
      return launch<32, kPacked>(qmap, smap, prm, smem, stream);
    case 64:
      return launch<64, kPacked>(qmap, smap, prm, smem, stream);
    case 128:
      return launch<128, kPacked>(qmap, smap, prm, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
