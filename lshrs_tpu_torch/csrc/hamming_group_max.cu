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

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;          // queries per tile (one wgmma M)
constexpr int kBN = 256;         // slots per tile (one wgmma N)
constexpr int kKB = 128;         // bytes per k-block (the 128-byte swizzle span)
constexpr int kThreads = 352;    // two consumer warpgroups + three producer warps
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

template <int G>
__global__ void __launch_bounds__(kThreads, 1) hamming_group_max_kernel(
    const __grid_constant__ CUtensorMap qmap,   // qbits (q, pp), box 128 x 64
    const __grid_constant__ CUtensorMap pmap,   // planes (c, pp), box 128 x 256
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
  // when resident).
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
      mbar_init(bars + 8u * i, 1);                // full: the producer's expect_tx
      mbar_init(bars + 8u * (2 * D + i), 128);    // empty: every consumer thread
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(tile_full(b), 32);  // the slot-tile producer's lanes
      mbar_init(tile_empty(b), 2);  // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    const int pw = t128 / 32;
    if (pw < 2) {
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
          if (!resident) tma_load(stage_addr(pw, s) + kABytes, &pmap, bar, kb * kKB, t * kBN);
          if (++s == D) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      return;
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
          tma_load(base + static_cast<uint32_t>((b * nkb + kb) * kBBytes), &pmap, tile_full(b),
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

template <int G>
int launch(const CUtensorMap& qmap, const CUtensorMap& pmap, const Params& prm, int smem,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(hamming_group_max_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = prm.ntiles < sms ? prm.ntiles : sms;
  hamming_group_max_kernel<G><<<grid, kThreads, smem, stream>>>(qmap, pmap, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

  // Shared memory: [resident planes nb x nkb x 32 KB][2 x stages][bias
  // 2 x 1 KB][barriers], plus 1 KB to align the base. Prefer two planes
  // buffers (the next slot tile prefetched), then one, then streaming.
  const int fixed = 1024 + 2 * kBN * 4 + (4 * kMaxStages + 4) * 8;
  const int avail = kSmemMax - fixed;
  const int plane_tile = prm.nkb * kBBytes;
  int nb = 0, stages = 0;
  for (int b = 2; b >= 1 && nb == 0; --b) {
    const int s = (avail - b * plane_tile) / (2 * kABytes);
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
  prm.stages_off = static_cast<uint32_t>(nb * plane_tile);
  prm.bias_off = prm.stages_off + 2u * stages * prm.stage_bytes;
  prm.bar_off = prm.bias_off + 2u * kBN * 4u;
  const int smem = static_cast<int>(prm.bar_off) + (4 * stages + 4) * 8 + 1024;

  CUtensorMap qmap, pmap;
  if (!make_map(&qmap, qbits, q, pp, kBM) || !make_map(&pmap, planes, c, pp, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 16:
      return launch<16>(qmap, pmap, prm, smem, st);
    case 32:
      return launch<32>(qmap, pmap, prm, smem, st);
    case 64:
      return launch<64>(qmap, pmap, prm, smem, st);
    case 128:
      return launch<128>(qmap, pmap, prm, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
