/* Structured (Hadamard) LSH projection — host hot path.
 *
 * Computes, per input vector, `nblocks` pseudo-random rotations
 *     y = H D3 H D2 H D1 x_pad          (H = unnormalised Walsh-Hadamard)
 * and emits the first `num_perm` rotated coordinates.  Signs of these
 * coordinates are the hash bits (thresholding + bitpack stay in Python).
 *
 * The butterfly pass order (h = 1, 2, 4, ..., dpad/2; within a pass,
 * pairs (i + t, i + t + h)) is the normative association order for the
 * whole framework: the NumPy and JAX implementations in
 * `lshrs_tpu/hash/fwht.py` perform the *same* adds in the same tree, so
 * all three paths produce bit-identical float32 coordinates (addition is
 * IEEE-deterministic once the association is fixed — this is what keeps
 * host- and device-hashed signatures interchangeable per store).  Do NOT
 * compile with -ffast-math: reassociation breaks that contract.
 *
 * Layout: vectors are processed VB at a time in a transposed (dpad, VB)
 * scratch block, so every butterfly pair is an add/sub of two contiguous
 * VB-float rows — fully SIMD at every pass width h (the straightforward
 * per-vector layout leaves h < vector-width passes strided and measured
 * ~2x slower than the host sgemm it is meant to replace).  Lane position
 * within the block never changes a vector's own association order.
 *
 * Once the scratch block exceeds L1 (dpad >= 1024: 64 KB at VB = 16) the
 * transform is L2-bandwidth-bound, so consecutive pass pairs (h, 2h) fuse
 * into radix-4 sweeps and the inter-stage diagonal multiplies fold into
 * the following sweep's loads — 17 block sweeps per rotation instead of
 * 33.  The radix-4 butterfly materialises exactly the intermediates the
 * sequential pass h would have stored (t0 = a+b, t1 = a-b, ...), so the
 * association tree — and every float32 rounding — is unchanged (verified
 * bit-exact against the scalar path).  Below 1024 the block is L1-resident
 * and the plain radix-2 sweep measured faster; both geometries are kept.
 *
 * Single-threaded by design (the serving host is 1 core; the Python side
 * overlaps hashing with device dispatch via threads, and ctypes drops the
 * GIL for the duration of the call).
 */

#include <stdint.h>
#include <string.h>

#define FWHT_MAX_DPAD 8192
#define VB 16 /* batch lanes per block: one AVX-512 f32 vector */

static void fwht_vec(float *buf, long dpad) {
    for (long h = 1; h < dpad; h <<= 1) {
        for (long i = 0; i < dpad; i += h << 1) {
            float *a = buf + i;
            float *b = buf + i + h;
            for (long t = 0; t < h; ++t) {
                float x = a[t];
                float y = b[t];
                a[t] = x + y;
                b[t] = x - y;
            }
        }
    }
}

/* buf: (dpad, VB) row-major — butterflies over rows, SIMD over lanes. */
static void fwht_block(float *buf, long dpad) {
    for (long h = 1; h < dpad; h <<= 1) {
        for (long i = 0; i < dpad; i += h << 1) {
            for (long t = 0; t < h; ++t) {
                float *a = buf + (i + t) * VB;
                float *b = buf + (i + t + h) * VB;
                for (int v = 0; v < VB; ++v) {
                    float x = a[v];
                    float y = b[v];
                    a[v] = x + y;
                    b[v] = x - y;
                }
            }
        }
    }
}

/* One radix-2 pass at width h over the (dpad, VB) block; scale (nullable)
 * is applied on load, row j multiplied by scale[j]. */
static void pass2_block(float *buf, long dpad, long h, const float *scale) {
    for (long i = 0; i < dpad; i += h << 1) {
        for (long t = 0; t < h; ++t) {
            float *a = buf + (i + t) * VB;
            float *b = buf + (i + t + h) * VB;
            if (scale) {
                float sa = scale[i + t];
                float sb = scale[i + t + h];
                for (int v = 0; v < VB; ++v) {
                    float x = a[v] * sa;
                    float y = b[v] * sb;
                    a[v] = x + y;
                    b[v] = x - y;
                }
            } else {
                for (int v = 0; v < VB; ++v) {
                    float x = a[v];
                    float y = b[v];
                    a[v] = x + y;
                    b[v] = x - y;
                }
            }
        }
    }
}

/* Two fused passes (h, 2h).  t0..t3 are exactly the values the sequential
 * pass h would have stored — association (and rounding) is unchanged. */
static void pass4_block(float *buf, long dpad, long h, const float *scale) {
    for (long i = 0; i < dpad; i += h << 2) {
        for (long t = 0; t < h; ++t) {
            float *pa = buf + (i + t) * VB;
            float *pb = buf + (i + t + h) * VB;
            float *pc = buf + (i + t + 2 * h) * VB;
            float *pd = buf + (i + t + 3 * h) * VB;
            if (scale) {
                float sa = scale[i + t];
                float sb = scale[i + t + h];
                float sc = scale[i + t + 2 * h];
                float sd = scale[i + t + 3 * h];
                for (int v = 0; v < VB; ++v) {
                    float a = pa[v] * sa;
                    float b = pb[v] * sb;
                    float c = pc[v] * sc;
                    float d = pd[v] * sd;
                    float t0 = a + b, t1 = a - b, t2 = c + d, t3 = c - d;
                    pa[v] = t0 + t2;
                    pb[v] = t1 + t3;
                    pc[v] = t0 - t2;
                    pd[v] = t1 - t3;
                }
            } else {
                for (int v = 0; v < VB; ++v) {
                    float a = pa[v];
                    float b = pb[v];
                    float c = pc[v];
                    float d = pd[v];
                    float t0 = a + b, t1 = a - b, t2 = c + d, t3 = c - d;
                    pa[v] = t0 + t2;
                    pb[v] = t1 + t3;
                    pc[v] = t0 - t2;
                    pd[v] = t1 - t3;
                }
            }
        }
    }
}

/* Full FWHT with an optional on-load scale: pass widths h = 1, 2, 4, ...
 * exactly as fwht_block, consecutive pairs fused into radix-4 sweeps (an
 * odd pass count leads with one radix-2 pass). */
static void fwht_block_fused(float *buf, long dpad, const float *scale) {
    long h = 1;
    long npass = 0;
    for (long d = dpad; d > 1; d >>= 1) ++npass;
    if (npass & 1) {
        pass2_block(buf, dpad, 1, scale);
        scale = 0;
        h = 2;
    }
    for (; h < dpad; h <<= 2) {
        pass4_block(buf, dpad, h, scale);
        scale = 0;
    }
}

/* Scratch blocks of 64 KB+ spill L1; switch to the fused sweeps there. */
#define FUSE_MIN_DPAD 1024

static void run_block(const float *x, long dim, const float *diags,
                      long nblocks, long dpad, long num_perm, float *out,
                      long vb, float *buf) {
    /* x: vb consecutive vectors (vb <= VB); buf: (dpad, VB) scratch. */
    int fused = dpad >= FUSE_MIN_DPAD;
    for (long blk = 0, produced = 0; blk < nblocks && produced < num_perm;
         ++blk) {
        const float *d0 = diags + (blk * 3 + 0) * dpad;
        const float *d1 = diags + (blk * 3 + 1) * dpad;
        const float *d2 = diags + (blk * 3 + 2) * dpad;
        for (long j = 0; j < dim; ++j) {
            float d = d0[j];
            float *row = buf + j * VB;
            for (long v = 0; v < vb; ++v) row[v] = x[v * dim + j] * d;
            for (long v = vb; v < VB; ++v) row[v] = 0.0f;
        }
        if (dim < dpad)
            memset(buf + dim * VB, 0, (size_t)(dpad - dim) * VB * sizeof(float));
        if (fused) {
            fwht_block_fused(buf, dpad, 0);
            fwht_block_fused(buf, dpad, d1);
            fwht_block_fused(buf, dpad, d2);
        } else {
            fwht_block(buf, dpad);
            for (long j = 0; j < dpad; ++j) {
                float d = d1[j];
                float *row = buf + j * VB;
                for (int v = 0; v < VB; ++v) row[v] *= d;
            }
            fwht_block(buf, dpad);
            for (long j = 0; j < dpad; ++j) {
                float d = d2[j];
                float *row = buf + j * VB;
                for (int v = 0; v < VB; ++v) row[v] *= d;
            }
            fwht_block(buf, dpad);
        }
        long remain = num_perm - produced;
        long take = remain < dpad ? remain : dpad;
        for (long v = 0; v < vb; ++v) {
            float *ov = out + v * num_perm + produced;
            for (long j = 0; j < take; ++j) ov[j] = buf[j * VB + v];
        }
        produced += take;
    }
}

/* x: (n, dim) f32 row-major; diags: (nblocks, 3, dpad) f32 of +-1;
 * out: (n, num_perm) f32.  Requires dim <= dpad <= FWHT_MAX_DPAD,
 * dpad a power of two, num_perm <= nblocks * dpad.  Returns 0 on
 * success, nonzero on parameter errors. */
int fwht_structured(const float *x, long n, long dim, const float *diags,
                    long nblocks, long dpad, long num_perm, float *out) {
    if (dpad <= 0 || dpad > FWHT_MAX_DPAD || dim > dpad) return 1;
    if ((dpad & (dpad - 1)) != 0) return 2;
    if (num_perm > nblocks * dpad) return 3;

    /* Thread-local scratch: ctypes releases the GIL for this call, and
     * concurrent host hashing (serving closures on worker threads) is an
     * expected workload — a shared static buffer would interleave the
     * in-place butterflies of two threads and silently corrupt hashes. */
    static _Thread_local float buf[FWHT_MAX_DPAD * VB];
    for (long v0 = 0; v0 < n; v0 += VB) {
        long vb = n - v0 < VB ? n - v0 : VB;
        run_block(x + v0 * dim, dim, diags, nblocks, dpad, num_perm,
                  out + v0 * num_perm, vb, buf);
    }
    return 0;
}

/* Kept for reference/tests: per-vector scalar path, same association. */
int fwht_structured_scalar(const float *x, long n, long dim,
                           const float *diags, long nblocks, long dpad,
                           long num_perm, float *out) {
    if (dpad <= 0 || dpad > FWHT_MAX_DPAD || dim > dpad) return 1;
    if ((dpad & (dpad - 1)) != 0) return 2;
    if (num_perm > nblocks * dpad) return 3;

    float buf[FWHT_MAX_DPAD];
    for (long v = 0; v < n; ++v) {
        const float *xv = x + v * dim;
        float *ov = out + v * num_perm;
        long produced = 0;
        for (long blk = 0; blk < nblocks && produced < num_perm; ++blk) {
            const float *d0 = diags + (blk * 3 + 0) * dpad;
            const float *d1 = diags + (blk * 3 + 1) * dpad;
            const float *d2 = diags + (blk * 3 + 2) * dpad;
            for (long j = 0; j < dim; ++j) buf[j] = xv[j] * d0[j];
            for (long j = dim; j < dpad; ++j) buf[j] = 0.0f;
            fwht_vec(buf, dpad);
            for (long j = 0; j < dpad; ++j) buf[j] *= d1[j];
            fwht_vec(buf, dpad);
            for (long j = 0; j < dpad; ++j) buf[j] *= d2[j];
            fwht_vec(buf, dpad);
            long remain = num_perm - produced;
            long take = remain < dpad ? remain : dpad;
            memcpy(ov + produced, buf, (size_t)take * sizeof(float));
            produced += take;
        }
    }
    return 0;
}
