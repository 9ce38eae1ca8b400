// Kernel B3: Hamming over packed words -> packed key -> group max, on
// Hopper's int8 tensor cores (the words expanded to +-1 tiles on chip).
//
// Replaces lshrs_tpu/ops/pallas_scan.py::hamming_packed_group_max_keys
// (kernel body _make_hamming_packed_kernel). For each (query, slot):
// ham = sum over the BW words of popc((sig_t[w, slot] ^ qwords[query, w])
// & low word_bits); key = bias - ham * scale, bias = (num_perm + 1) * scale
// + tie for alive slots (tie >= 0) and 0 for dead ones (so a dead key is
// <= 0, under every alive key, which is >= scale); write the max key of
// each group of `group` CONTIGUOUS slots. The alive key equals kernel B2's
// symmetric Hamming key, so both storages select the same groups.
//
// The same function as a +-1 product. Expand the low word_bits bits of
// each word to +1 (set) / -1 (clear), n = BW * word_bits columns, padded
// with zero columns to K = ceil(n / 32) * 32: then dot = n - 2 * ham, and
// B2's key ((dot + offset) >> 1) * scale + bias with offset = 2 * num_perm
// - n, bias tie + scale alive and -num_perm * scale dead is exactly B3's
// key, (num_perm + 1 - ham) * scale + tie alive and -ham * scale dead
// (int32 arithmetic wraps alike on both sides).
//
// What bounds it on the H100: the product, 2 * Q * C * K int8 operations
// at 1,979 TOP/s (0.139 ms at Q = 512, C = 2^20, K = 256, the 16 x 16
// store's words at word_bits 16; 8.89 ms at Q = 8192, C = 2^22). The
// bytes are minor: the words (4 * BW * C) are read once, the group maxima
// (4 * Q * C / group) written once.
//
// Design: kernel B2's pipeline (hamming_wgmma.cuh, kPacked = true) with a
// slot producer that expands packed words, not one that loads planes. The
// producer warp stages a slot tile's BW x 256 words by TMA (16 KB at
// BW = 16), turns each slot's words into 16-byte +-1 chunks (4 bits to 4
// bytes by one multiply-spread each) and stores them, swizzled as B2's
// TMA would, into the resident slot-tile buffer; the next tile's words
// load while it expands and the tile before is multiplied, and every
// 64-query tile of the batch then streams past the expanded tile. The
// queries are expanded once per call by the wrapper
// (ops/group_max.py::packed_operand, Q * K bytes) and loaded by B2's
// query TMA path. So the store keeps its 4 * BW bytes per slot and no
// (C, K) array exists anywhere. Where K passes 640 bytes (BW > 20 at 32
// bits), the tile does not fit resident and each query producer warp
// expands the slot k-block beside its query k-block per query tile.

#include "hamming_wgmma.cuh"

namespace {

constexpr int kMaxBW = 64;  // words per slot the wrapper accepts

// The (bw, c) int32 words as 256-slot x bw TMA boxes; slots past c read as
// zero (their keys are dead and masked on store).
bool make_words_map(CUtensorMap* map, const void* ptr, int bw, int c) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(bw)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBN), static_cast<cuuint32_t>(bw)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Returns a cudaError_t: 0 on a launched kernel. `qop` is the (q, kp) +-1
// int8 query operand, kp = ceil(bw * word_bits / 32) * 32 columns. The
// caller validates shapes; an argument this kernel cannot take (more than
// 64 words, word_bits outside 1..32, another kp, group outside {16, 32,
// 64, 128}, C not a multiple of group, a pointer not 16-byte aligned)
// returns cudaErrorInvalidValue without launching.
extern "C" int lshrs_hamming_packed_group_max(const void* sig_t, const void* tie, const void* qop,
                                              void* out, int q, int c, int bw, int word_bits,
                                              int kp, int group, int scale, int num_perm,
                                              void* stream) {
  const int nbits = bw * word_bits;
  if (q <= 0 || c <= 0 || bw <= 0 || bw > kMaxBW || word_bits <= 0 || word_bits > 32 ||
      num_perm <= 0 || kp != (nbits + 31) / 32 * 32 ||
      (group != 16 && group != 32 && group != 64 && group != 128) || c % group != 0 ||
      reinterpret_cast<uintptr_t>(sig_t) % 16 != 0 || reinterpret_cast<uintptr_t>(qop) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm{};
  prm.tie = static_cast<const int32_t*>(tie);
  prm.out = static_cast<int32_t*>(out);
  prm.q = q;
  prm.c = c;
  prm.pp = kp;
  prm.nkb = (kp + kKB - 1) / kKB;
  prm.nqt = (q + kBM - 1) / kBM;
  prm.ntiles = (c + kBN - 1) / kBN;
  prm.scale = scale;
  prm.offset = 2 * num_perm - nbits;
  prm.shift = 1;
  prm.dead_bias = -num_perm * scale;
  prm.words = static_cast<const int32_t*>(sig_t);
  prm.bw = bw;
  prm.wb = word_bits;
  prm.nbits = nbits;

  const int smem = plan_smem(prm, true);

  CUtensorMap qmap, wmap;
  if (!make_map(&qmap, qop, q, kp, kBM) || !make_words_map(&wmap, sig_t, bw, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_group<true>(group, qmap, wmap, prm, smem, static_cast<cudaStream_t>(stream));
}
