// The proof's tail of the STARK prover, from the out-of-domain point to
// the FRI fold, in the extension of degree D = 1, 2, 3 (x^2 = 3; x^3 =
// 3x + 1: params/extensions.py), as three kernels:
//
//   ood       sum_i c_i p^(s + i) of every trace column at p = z and z g
//             and of every composition column at z^k (two launches: a
//             block's strip of indices, then the blocks' partial sums);
//   deep      sum_j g_z,j (f_j(x) - f_j(z)) / (x - z) + the same at z g
//             + sum_j g_h,j (H_j(x) - H_j(z^k)) / (x - z^k) on a domain
//             segment (a block first sums sum_j g_j f_j(p) at the three
//             points, the terms that do not depend on x);
//   fri_fold  one FRI layer's fold by 2, or by 4 as two radix-2 folds with
//             xi and xi^2, in registers.
//
// Replace certificate_stark_tpu/engine/prover.py `phase_ood` (:748),
// `_deep_pointwise` (:802, with `phase_deep` :829) and `fold_kernel`
// (:1088, over engine/fri.py :105 `fold2_ext`), XLA on the TPU, and the
// port's PyTorch routes around f63_mul, which are the plain versions
// (ops/kernels.py `ood_plain`, `deep_plain`, `fri_fold_plain`). The CPU
// templates are native/deep_compose.c `f63_deep` (:198) and
// `f63_fri_fold2` (:306).
//
// Every value is canonical and every operation exact mod p, so any order
// of the sums and any way to the same inverse gives the plain version's
// bits. What bounds each on the H100 (3.35 TB/s, 16.7 T 32-bit integer
// operations a second):
// - ood reads the w trace and d k composition coefficient columns once:
//   at w = 94, m = 2^20 ~0.8 GB (0.24 ms). Its products are 2 d a trace
//   coefficient and d^2 a composition one, summed unreduced: at d = 3
//   some 6k 32-bit multiplies an index, ~0.4 ms. No [d, 2, w, m] product
//   and no powers table of the domain's size exists: a block builds its
//   strip's powers of the three points in shared memory by doubling (one
//   extension multiply an index and point), from a start power
//   p^(s + i0) by square-and-multiply;
// - deep reads w trace values and d k composition values a point and
//   writes d: at w = 94, d = 3, 2^20 points ~0.99 GB (0.3 ms). Its sums
//   stay unreduced as compose's do (Wide, f63.cuh); the three quotients
//   share one denominator (x - z)(x - z g)(x - z^k), whose inverses a
//   thread takes by Montgomery's trick over its run of DeepRun<D>::R
//   points: one base-field inversion a run (66 squarings, 16 multiplies),
//   not a product tree over the domain. A zero denominator is replaced by
//   1 before the product and its point written 0, the rule of
//   F.batch_inv;
// - fri_fold reads fold d values and writes d a point: bytes bound it.
//   1/x comes from a split table (lo[e mod 2^h] hi[e >> h] = (o w^e)^-1).
#include <cuda_runtime.h>

#include "f63.cuh"

#define OOD_THREADS 256
#define OOD_LOG_STRIP 9               // a block's indices: ops/kernels.py
#define OOD_STRIP (1 << OOD_LOG_STRIP)  // OOD_STRIP
#define DEEP_THREADS 128
#define FOLD_THREADS 256

// DEEP's points a thread (its run for Montgomery's trick): three extension
// values a point stay in registers through the run.
template <int D>
struct DeepRun {
    static constexpr int R = D == 3 ? 4 : 8;
};

__device__ __forceinline__ u64 mtriple(u64 a) {
    return f63_add(f63_add(a, a), a);
}

// The coordinates of an extension product from its 2D - 1 coefficient
// sums r (reduced): x^2 = 3 for D = 2; x^3 = 3x + 1, x^4 = 3x^2 + x for
// D = 3.
template <int D>
__device__ __forceinline__ void ext_combine(const u64 (&r)[2 * D - 1],
                                            u64 (&c)[D]) {
    if constexpr (D == 1) {
        c[0] = r[0];
    } else if constexpr (D == 2) {
        c[0] = f63_add(r[0], mtriple(r[2]));
        c[1] = r[1];
    } else {
        c[0] = f63_add(r[0], r[3]);
        c[1] = f63_add(f63_add(r[1], mtriple(r[3])), r[4]);
        c[2] = f63_add(r[2], mtriple(r[4]));
    }
}

// t[i + j] += a_i b_j, unreduced (at most D products a sum a call).
template <int D>
__device__ __forceinline__ void ext_mac(Wide (&t)[2 * D - 1],
                                        const u64* a, const u64* b) {
#pragma unroll
    for (int i = 0; i < D; i++)
#pragma unroll
        for (int j = 0; j < D; j++) wide_mac(t[i + j], a[i], b[j]);
}

template <int D>
__device__ __forceinline__ void ext_reduce(const Wide (&t)[2 * D - 1],
                                           u64 (&c)[D]) {
    u64 r[2 * D - 1];
#pragma unroll
    for (int i = 0; i < 2 * D - 1; i++) r[i] = wide_redc(t[i]);
    ext_combine<D>(r, c);
}

// c = a b; c may be a or b.
template <int D>
__device__ __forceinline__ void ext_mul(const u64 (&a)[D], const u64 (&b)[D],
                                        u64 (&c)[D]) {
    if constexpr (D == 1) {
        c[0] = f63_mmul(a[0], b[0]);
    } else {
        Wide t[2 * D - 1];
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) wide_zero(t[i]);
        ext_mac<D>(t, a, b);
        ext_reduce<D>(t, c);
    }
}

template <int D>
__device__ __forceinline__ void ext_one(u64 (&a)[D]) {
    a[0] = F63_ONE;
#pragma unroll
    for (int e = 1; e < D; e++) a[e] = 0;
}

template <int D>
__device__ __forceinline__ bool ext_is_zero(const u64 (&a)[D]) {
    u64 any = 0;
#pragma unroll
    for (int e = 0; e < D; e++) any |= a[e];
    return any == 0;
}

// x^(p - 2), the base-field inverse (0 maps to 0): p - 2 = 0b1000001 0
// then 55 ones, as x^65 squared, then eleven windows of five ones
// (x^31): 66 squarings and 16 multiplies.
__device__ u64 inv_base(u64 x) {
    const u64 x3 = f63_mmul(f63_msqr(x), x);
    const u64 x7 = f63_mmul(f63_msqr(x3), x);
    const u64 x15 = f63_mmul(f63_msqr(x7), x);
    const u64 x31 = f63_mmul(f63_msqr(x15), x);
    u64 y = x;
#pragma unroll
    for (int i = 0; i < 6; i++) y = f63_msqr(y);
    y = f63_msqr(f63_mmul(y, x));  // x^130
#pragma unroll 1
    for (int i = 0; i < 11; i++) {
#pragma unroll
        for (int k = 0; k < 5; k++) y = f63_msqr(y);
        y = f63_mmul(y, x31);
    }
    return y;
}

// 1 / a in the extension (0 maps to 0): the adjugate over the norm, as
// ops/extfield.py `ext_inv_vec` takes it.
template <int D>
__device__ void ext_inv(const u64 (&a)[D], u64 (&c)[D]) {
    if constexpr (D == 1) {
        c[0] = inv_base(a[0]);
    } else if constexpr (D == 2) {
        const u64 n = msub(f63_msqr(a[0]), mtriple(f63_msqr(a[1])));
        const u64 t = inv_base(n);
        c[0] = f63_mmul(a[0], t);
        c[1] = f63_mmul(msub(0, a[1]), t);
    } else {
        // the multiplication matrix [[a0, m12, m13], [a1, m11, m23],
        // [a2, a1, m11]]; its first row's cofactors over the determinant
        const u64 a0 = a[0], a1 = a[1], a2 = a[2];
        const u64 m11 = f63_add(a0, mtriple(a2)), m12 = a2, m13 = a1;
        const u64 m23 = f63_add(m12, mtriple(a1));
        const u64 c0 = msub(f63_msqr(m11), f63_mmul(m23, a1));
        const u64 c1 = msub(f63_mmul(m23, a2), f63_mmul(a1, m11));
        const u64 c2 = msub(f63_msqr(a1), f63_mmul(m11, a2));
        const u64 det = f63_add(f63_add(f63_mmul(a0, c0), f63_mmul(m12, c1)),
                                f63_mmul(m13, c2));
        const u64 t = inv_base(det);
        c[0] = f63_mmul(c0, t);
        c[1] = f63_mmul(c1, t);
        c[2] = f63_mmul(c2, t);
    }
}

// b^e, square-and-multiply from the low bit.
template <int D>
__device__ void ext_pow(const u64 (&b)[D], unsigned long long e,
                        u64 (&r)[D]) {
    u64 x[D];
#pragma unroll
    for (int i = 0; i < D; i++) x[i] = b[i];
    ext_one<D>(r);
#pragma unroll 1
    while (e) {
        if (e & 1) ext_mul<D>(r, x, r);
        e >>= 1;
        if (e) ext_mul<D>(x, x, x);
    }
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
        v = f63_add(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// ---- ood -------------------------------------------------------------------
struct OodArgs {
    const u64* coef;  // trace coefficients [w, m], row stride c_ld
    long long c_ld;
    int w;
    const u64* h;  // composition coefficients: coordinate e of column c at
    long long h_le, h_lc;  // index i is h[e h_le + c h_lc + i]
    int k;
    const u64* pts;  // [D, 3]: z, z g, z^k
    unsigned long long s;  // the exponent of index 0
    long long m;
    u64* part;  // [blocks, V], V = D (2 w + k)
};

// A block's strip [i0, i0 + OOD_STRIP): the powers p_q^(s + i0 + i) of the
// three points in shared memory ([3][D][OOD_STRIP], by doubling from the
// start power, one extension multiply an index and point), then a warp a
// column: its lanes' products summed unreduced, reduced, added over the
// warp; lane 0 writes the block's partial sum of the column.
template <int D>
__global__ void __launch_bounds__(OOD_THREADS)
ood_kernel(const __grid_constant__ OodArgs p) {
    __shared__ u64 tbl[3][D][OOD_STRIP];
    __shared__ u64 sq[3][OOD_LOG_STRIP][D];  // p_q^(2^r)
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long i0 = (long long)blockIdx.x * OOD_STRIP;
    if (tid < 3) {
        u64 b[D], r[D];
#pragma unroll
        for (int e = 0; e < D; e++) b[e] = __ldg(p.pts + e * 3 + tid);
        ext_pow<D>(b, p.s + (unsigned long long)i0, r);
#pragma unroll
        for (int e = 0; e < D; e++) {
            tbl[tid][e][0] = r[e];
            sq[tid][0][e] = b[e];
        }
#pragma unroll 1
        for (int l = 1; l < OOD_LOG_STRIP; l++) {
            ext_mul<D>(b, b, b);
#pragma unroll
            for (int e = 0; e < D; e++) sq[tid][l][e] = b[e];
        }
    }
    __syncthreads();
#pragma unroll 1
    for (int l = 0; l < OOD_LOG_STRIP; l++) {
        const int half = 1 << l;
        for (int u = tid; u < 3 * half; u += OOD_THREADS) {
            const int q = u >> l, i = u & (half - 1);
            u64 a[D], b[D];
#pragma unroll
            for (int e = 0; e < D; e++) {
                a[e] = tbl[q][e][i];
                b[e] = sq[q][l][e];
            }
            ext_mul<D>(a, b, a);
#pragma unroll
            for (int e = 0; e < D; e++) tbl[q][e][half + i] = a[e];
        }
        __syncthreads();
    }
    const int w = p.w, V = D * (2 * w + p.k);
    const long long avail = p.m - i0;  // indices of the strip that exist
    u64* part = p.part + (long long)blockIdx.x * V;
    constexpr int U = OOD_STRIP / 32;  // indices a lane
    for (int c = warp; c < w + p.k; c += OOD_THREADS / 32) {
        if (c < w) {
            Wide s[2][D];
#pragma unroll
            for (int q = 0; q < 2; q++)
#pragma unroll
                for (int e = 0; e < D; e++) wide_zero(s[q][e]);
            const u64* row = p.coef + c * p.c_ld + i0;
            // the lane's U coefficients loaded together (0 past the end),
            // a fold of every sum after each FOLD_EVERY of them
            u64 a[U];
#pragma unroll
            for (int u = 0; u < U; u++)
                a[u] = u * 32 + lane < avail ? __ldg(row + u * 32 + lane) : 0;
#pragma unroll
            for (int u = 0; u < U; u++) {
                const int i = u * 32 + lane;
#pragma unroll
                for (int q = 0; q < 2; q++)
#pragma unroll
                    for (int e = 0; e < D; e++)
                        wide_mac(s[q][e], a[u], tbl[q][e][i]);
                if (u % FOLD_EVERY == FOLD_EVERY - 1 || u == U - 1) {
#pragma unroll
                    for (int q = 0; q < 2; q++)
#pragma unroll
                        for (int e = 0; e < D; e++) wide_fold(s[q][e]);
                }
            }
#pragma unroll
            for (int q = 0; q < 2; q++)
#pragma unroll
                for (int e = 0; e < D; e++) {
                    const u64 v = warp_sum(wide_redc(s[q][e]));
                    if (lane == 0) part[e * (2 * w + p.k) + q * w + c] = v;
                }
        } else {
            const int cc = c - w;
            Wide t[2 * D - 1];
#pragma unroll
            for (int i = 0; i < 2 * D - 1; i++) wide_zero(t[i]);
            const u64* col = p.h + cc * p.h_lc + i0;
#pragma unroll 1
            for (int u = 0; u < U; u++) {
                const int i = u * 32 + lane;
                if (i < avail) {
                    u64 a[D], b[D];
#pragma unroll
                    for (int e = 0; e < D; e++) {
                        a[e] = __ldg(col + e * p.h_le + i);
                        b[e] = tbl[2][e][i];
                    }
                    ext_mac<D>(t, a, b);
#pragma unroll
                    for (int i2 = 0; i2 < 2 * D - 1; i2++) wide_fold(t[i2]);
                }
            }
            u64 v[D];
            ext_reduce<D>(t, v);
#pragma unroll
            for (int e = 0; e < D; e++) {
                const u64 x = warp_sum(v[e]);
                if (lane == 0) part[e * (2 * w + p.k) + 2 * w + cc] = x;
            }
        }
    }
}

// out[v] = sum of the blocks' partials part[b][v].
__global__ void __launch_bounds__(256)
ood_total_kernel(const u64* __restrict__ part, int B, int V,
                 u64* __restrict__ out) {
    const int v = blockIdx.x * 256 + threadIdx.x;
    if (v >= V) return;
    u64 s = 0;
#pragma unroll 4
    for (int b = 0; b < B; b++)
        s = f63_add(s, __ldg(part + (long long)b * V + v));
    out[v] = s;
}

template <int D>
static int ood_run(const OodArgs& p, int B, u64* out, cudaStream_t st) {
    ood_kernel<D><<<B, OOD_THREADS, 0, st>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int V = D * (2 * p.w + p.k);
    ood_total_kernel<<<(V + 255) / 256, 256, 0, st>>>(p.part, B, V, out);
    return (int)cudaGetLastError();
}

// coef [w, m] (row stride c_ld), the composition coefficients h (element
// e h_le + c h_lc + i), the points pts [d, 3], the exponent s of index 0;
// part [ceil(m / OOD_STRIP), V] scratch; out [d, 2 w + k]: the trace
// columns at z, then at z g, then the composition columns at z^k.
extern "C" int ood_launch(const void* coef, long long c_ld, int w,
                          const void* h, long long h_le, long long h_lc,
                          int k, const void* pts, long long s, long long m,
                          int d, void* part, void* out, void* stream) {
    if (m <= 0 || 2 * w + k <= 0) return 0;
    const int B = (int)((m + OOD_STRIP - 1) / OOD_STRIP);
    const OodArgs p = {(const u64*)coef, c_ld, w, (const u64*)h, h_le, h_lc,
                       k, (const u64*)pts, (unsigned long long)s, m,
                       (u64*)part};
    const cudaStream_t st = (cudaStream_t)stream;
    if (d == 1) return ood_run<1>(p, B, (u64*)out, st);
    if (d == 2) return ood_run<2>(p, B, (u64*)out, st);
    if (d == 3) return ood_run<3>(p, B, (u64*)out, st);
    return (int)cudaErrorInvalidValue;
}

// ---- deep ------------------------------------------------------------------
struct DeepArgs {
    const u64* lde;  // the trace segment [w, S], row stride lde_ld
    long long lde_ld;
    const u64* h;  // composition segment: coordinate e of column c at
    long long h_le, h_lc;  // point j is h[e h_le + c h_lc + j]
    const u64* xs;  // the segment's domain points [S]
    const u64* pts;  // [D, 3]: z, z g, z^k
    const u64 *oz, *ozg, *oh;  // f_j(z), f_j(z g) [D, w]; H_j(z^k) [D, k]
    const u64 *gz, *gzg, *gh;  // [D, w], [D, w], [D, k]
    int w, k;
    long long S;
    u64* out;  // [D, S], row stride out_ld
    long long out_ld;
};

// Point j's numerator N = n_z (x - z g)(x - z^k) + n_zg (x - z)(x - z^k) +
// n_h (x - z)(x - z g) and denominator (x - z)(x - z g)(x - z^k), with
// n_z = sum_j g_z,j f_j(x) - cc_z etc.: N / den is the DEEP value.
template <int D>
__device__ __forceinline__ void deep_point(const DeepArgs& p,
                                           const u64* gt, const u64* gk,
                                           const u64 (&pz)[3][D],
                                           const u64 (&cz)[3][D],
                                           long long j, u64 (&num)[D],
                                           u64 (&den)[D]) {
    const int w = p.w;
    Wide s[2][D];
#pragma unroll
    for (int q = 0; q < 2; q++)
#pragma unroll
        for (int e = 0; e < D; e++) wide_zero(s[q][e]);
    const u64* col = p.lde + j;
    // FOLD_EVERY columns at a time, their loads issued together, then the
    // rest one at a time; a fold of every sum after each run
    int t = 0;
#pragma unroll 1
    for (; t + FOLD_EVERY <= w; t += FOLD_EVERY) {
        u64 f[FOLD_EVERY];
#pragma unroll
        for (int q = 0; q < FOLD_EVERY; q++)
            f[q] = __ldg(col + (t + q) * p.lde_ld);
#pragma unroll
        for (int q = 0; q < FOLD_EVERY; q++) {
            const u64* g = gt + (t + q) * 2 * D;
#pragma unroll
            for (int e = 0; e < D; e++) {
                wide_mac(s[0][e], f[q], g[e]);
                wide_mac(s[1][e], f[q], g[D + e]);
            }
        }
#pragma unroll
        for (int q = 0; q < 2; q++)
#pragma unroll
            for (int e = 0; e < D; e++) wide_fold(s[q][e]);
    }
#pragma unroll 1
    for (; t < w; t++) {
        const u64 f = __ldg(col + t * p.lde_ld);
        const u64* g = gt + t * 2 * D;
#pragma unroll
        for (int e = 0; e < D; e++) {
            wide_mac(s[0][e], f, g[e]);
            wide_mac(s[1][e], f, g[D + e]);
        }
    }
    u64 nz[D], nzg[D], nh[D];
#pragma unroll
    for (int e = 0; e < D; e++) {
        nz[e] = msub(wide_redc(s[0][e]), cz[0][e]);
        nzg[e] = msub(wide_redc(s[1][e]), cz[1][e]);
    }
    {
        Wide t[2 * D - 1];
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) wide_zero(t[i]);
#pragma unroll 1
        for (int c = 0; c < p.k; c++) {
            u64 hv[D];
#pragma unroll
            for (int e = 0; e < D; e++)
                hv[e] = __ldg(p.h + e * p.h_le + c * p.h_lc + j);
            ext_mac<D>(t, gk + c * D, hv);
#pragma unroll
            for (int i = 0; i < 2 * D - 1; i++) wide_fold(t[i]);
        }
        ext_reduce<D>(t, nh);
    }
#pragma unroll
    for (int e = 0; e < D; e++) nh[e] = msub(nh[e], cz[2][e]);
    const u64 x = __ldg(p.xs + j);
    u64 dz[D], dzg[D], dzk[D];
#pragma unroll
    for (int e = 0; e < D; e++) {
        const u64 a = e == 0 ? x : 0;
        dz[e] = msub(a, pz[0][e]);
        dzg[e] = msub(a, pz[1][e]);
        dzk[e] = msub(a, pz[2][e]);
    }
    u64 a[D], b[D], c[D];
    ext_mul<D>(dzg, dzk, a);
    ext_mul<D>(dz, dzk, b);
    ext_mul<D>(dz, dzg, c);
    ext_mul<D>(c, dzk, den);
    ext_mul<D>(nz, a, a);
    ext_mul<D>(nzg, b, b);
    ext_mul<D>(nh, c, c);
#pragma unroll
    for (int e = 0; e < D; e++) num[e] = f63_add(f63_add(a[e], b[e]), c[e]);
}

// The block's start: g_z, g_zg ([w][2][D]) and g_h ([k][D]) in shared
// memory, and warp q < 3 sums cz[q] = sum_j g_q,j f_j(p_q), the OOD values
// weighted as the numerators are (lanes over the columns). Then a thread's
// run of R points j = base + r DEEP_THREADS + tid (coalesced for each r):
// numerators and denominators, their prefix products, one inversion, then
// back through the run.
template <int D>
__global__ void __launch_bounds__(DEEP_THREADS)
deep_kernel(const __grid_constant__ DeepArgs p) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int R = DeepRun<D>::R;
    u64* gt = (u64*)smem;
    u64* gk = gt + 2 * D * p.w;
    const int tid = threadIdx.x;
    for (int q = tid; q < 2 * D * p.w; q += DEEP_THREADS) {
        const int c = q / (2 * D), r = q % (2 * D);
        gt[q] = __ldg((r < D ? p.gz : p.gzg) + (r % D) * p.w + c);
    }
    for (int q = tid; q < D * p.k; q += DEEP_THREADS)
        gk[q] = __ldg(p.gh + (q % D) * p.k + q / D);
    __shared__ u64 csum[3][D];
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 3) {
        const int n = warp < 2 ? p.w : p.k;
        const u64* g = warp == 0 ? p.gz : warp == 1 ? p.gzg : p.gh;
        const u64* o = warp == 0 ? p.oz : warp == 1 ? p.ozg : p.oh;
        Wide t[2 * D - 1];
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) wide_zero(t[i]);
        for (int c = lane; c < n; c += 32) {
            u64 a[D], b[D];
#pragma unroll
            for (int e = 0; e < D; e++) {
                a[e] = __ldg(g + e * n + c);
                b[e] = __ldg(o + e * n + c);
            }
            ext_mac<D>(t, a, b);
#pragma unroll
            for (int i = 0; i < 2 * D - 1; i++) wide_fold(t[i]);
        }
        u64 v[D];
        ext_reduce<D>(t, v);
#pragma unroll
        for (int e = 0; e < D; e++) {
            const u64 x = warp_sum(v[e]);
            if (lane == 0) csum[warp][e] = x;
        }
    }
    u64 pz[3][D];
#pragma unroll
    for (int q = 0; q < 3; q++)
#pragma unroll
        for (int e = 0; e < D; e++) pz[q][e] = __ldg(p.pts + e * 3 + q);
    __syncthreads();
    u64 cz[3][D];
#pragma unroll
    for (int q = 0; q < 3; q++)
#pragma unroll
        for (int e = 0; e < D; e++) cz[q][e] = csum[q][e];
    const long long tile = (long long)R * DEEP_THREADS;
    for (long long base = (long long)blockIdx.x * tile; base < p.S;
         base += (long long)gridDim.x * tile) {
        u64 num[R][D], den[R][D], pre[R][D];
        unsigned zero = 0;
#pragma unroll
        for (int r = 0; r < R; r++) {
            const long long j = base + r * DEEP_THREADS + tid;
            if (j < p.S) {
                deep_point<D>(p, gt, gk, pz, cz, j, num[r], den[r]);
            } else {
#pragma unroll
                for (int e = 0; e < D; e++) num[r][e] = 0;
                ext_one<D>(den[r]);
            }
            if (ext_is_zero<D>(den[r])) {
                zero |= 1u << r;
                ext_one<D>(den[r]);
            }
            if (r == 0) {
#pragma unroll
                for (int e = 0; e < D; e++) pre[0][e] = den[0][e];
            } else {
                ext_mul<D>(pre[r - 1], den[r], pre[r]);
            }
        }
        u64 inv[D];  // 1 / (den_0 ... den_r) as r falls
        ext_inv<D>(pre[R - 1], inv);
#pragma unroll
        for (int r = R - 1; r >= 0; r--) {
            u64 id[D];
            if (r > 0) {
                ext_mul<D>(inv, pre[r - 1], id);
                ext_mul<D>(inv, den[r], inv);
            } else {
#pragma unroll
                for (int e = 0; e < D; e++) id[e] = inv[e];
            }
            ext_mul<D>(num[r], id, id);
            const long long j = base + r * DEEP_THREADS + tid;
            if (j < p.S) {
#pragma unroll
                for (int e = 0; e < D; e++)
                    p.out[e * p.out_ld + j] = zero >> r & 1 ? 0 : id[e];
            }
        }
    }
}

template <int D>
static int deep_run(const DeepArgs& p, cudaStream_t st) {
    const int smem = 8 * D * (2 * p.w + p.k);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            deep_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long tile = (long long)DeepRun<D>::R * DEEP_THREADS;
    const long long blocks = (p.S + tile - 1) / tile;
    deep_kernel<D><<<(int)(blocks < (1 << 30) ? blocks : (1 << 30)),
                     DEEP_THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
}

// The trace segment lde [w, S] (row stride lde_ld), the composition
// segment h (element e h_le + c h_lc + j), the domain points xs [S], the
// points pts [d, 3], the OOD values oz, ozg [d, w] and oh [d, k], the
// coefficients g_z, g_zg [d, w] and g_h [d, k]; out [d, S] with row
// stride out_ld.
extern "C" int deep_launch(const void* lde, long long lde_ld, const void* h,
                           long long h_le, long long h_lc, const void* xs,
                           const void* pts, const void* oz, const void* ozg,
                           const void* oh, const void* gz, const void* gzg,
                           const void* gh, int w, int k, int d, long long S,
                           void* out, long long out_ld, void* stream) {
    if (S <= 0) return 0;
    const DeepArgs p = {(const u64*)lde, lde_ld, (const u64*)h, h_le, h_lc,
                        (const u64*)xs, (const u64*)pts, (const u64*)oz,
                        (const u64*)ozg, (const u64*)oh, (const u64*)gz,
                        (const u64*)gzg, (const u64*)gh, w, k, S, (u64*)out,
                        out_ld};
    const cudaStream_t st = (cudaStream_t)stream;
    if (d == 1) return deep_run<1>(p, st);
    if (d == 2) return deep_run<2>(p, st);
    if (d == 3) return deep_run<3>(p, st);
    return (int)cudaErrorInvalidValue;
}

// ---- fri_fold --------------------------------------------------------------
struct FoldArgs {
    const u64* src;  // value t, coordinate e of point j: src[t ld_t + e ld_e
    long long ld_t, ld_e;  // + j]
    long long L, j0;  // points; the first one's position in the layer
    const u64 *lo, *hi;  // (o w^e)^-1 = lo[e mod 2^h] hi[e >> h]
    int h;
    u64 step_inv;  // w^-step: 1/x at position e + step from 1/x at e
    u64 inv2;      // 1/2
    const u64* xi;  // [D]
    u64* out;       // [D, L]
};

// The radix-2 fold (a + b) / 2 + xi (a - b) / (2x) of the values a at x
// and b at -x, with hx = 1 / (2x).
template <int D>
__device__ __forceinline__ void fold_half(const u64 (&a)[D], const u64 (&b)[D],
                                          u64 hx, const u64 (&xi)[D],
                                          u64 inv2, u64 (&o)[D]) {
    u64 t[D];
#pragma unroll
    for (int e = 0; e < D; e++) t[e] = f63_mmul(msub(a[e], b[e]), hx);
    ext_mul<D>(t, xi, t);
#pragma unroll
    for (int e = 0; e < D; e++)
        o[e] = f63_add(f63_mmul(f63_add(a[e], b[e]), inv2), t[e]);
}

template <int D, int FOLD>
__global__ void __launch_bounds__(FOLD_THREADS)
fri_fold_kernel(const __grid_constant__ FoldArgs p) {
    const long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
    if (j >= p.L) return;
    u64 xi[D], v[FOLD][D];
#pragma unroll
    for (int e = 0; e < D; e++) xi[e] = __ldg(p.xi + e);
#pragma unroll
    for (int t = 0; t < FOLD; t++)
#pragma unroll
        for (int e = 0; e < D; e++)
            v[t][e] = __ldg(p.src + t * p.ld_t + e * p.ld_e + j);
    const unsigned long long pos = (unsigned long long)(p.j0 + j);
    const u64 ix = f63_mmul(__ldg(p.lo + (pos & ((1ull << p.h) - 1))),
                            __ldg(p.hi + (pos >> p.h)));  // 1 / x
    u64 o[D];
    if constexpr (FOLD == 2) {
        fold_half<D>(v[0], v[1], f63_mmul(ix, p.inv2), xi, p.inv2, o);
    } else {
        // values t and t + 2 at the positions j and j + step, then the two
        // folded values at x^2, with xi^2
        u64 g0[D], g1[D], xi2[D];
        fold_half<D>(v[0], v[2], f63_mmul(ix, p.inv2), xi, p.inv2, g0);
        fold_half<D>(v[1], v[3], f63_mmul(f63_mmul(ix, p.step_inv), p.inv2),
                     xi, p.inv2, g1);
        ext_mul<D>(xi, xi, xi2);
        fold_half<D>(g0, g1, f63_mmul(f63_msqr(ix), p.inv2), xi2, p.inv2, o);
    }
#pragma unroll
    for (int e = 0; e < D; e++) p.out[e * p.L + j] = o[e];
}

template <int D>
static int fold_run(const FoldArgs& p, int fold, cudaStream_t st) {
    const int blocks = (int)((p.L + FOLD_THREADS - 1) / FOLD_THREADS);
    if (fold == 2)
        fri_fold_kernel<D, 2><<<blocks, FOLD_THREADS, 0, st>>>(p);
    else if (fold == 4)
        fri_fold_kernel<D, 4><<<blocks, FOLD_THREADS, 0, st>>>(p);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// src: value t, coordinate e of point j at src[t ld_t + e ld_e + j] (t <
// fold, e < d, j < L); the points' positions j0 + j + t step in the
// layer, whose 1/x is lo[e mod 2^h] hi[e >> h]; step_inv = w^-step and
// inv2 Montgomery; xi [d]; out [d, L].
extern "C" int fri_fold_launch(const void* src, long long ld_t,
                               long long ld_e, long long L, long long j0,
                               const void* lo, const void* hi, int h,
                               long long step_inv, long long inv2,
                               const void* xi, int d, int fold, void* out,
                               void* stream) {
    if (L <= 0) return 0;
    const FoldArgs p = {(const u64*)src, ld_t, ld_e, L, j0, (const u64*)lo,
                        (const u64*)hi, h, (u64)step_inv, (u64)inv2,
                        (const u64*)xi, (u64*)out};
    const cudaStream_t st = (cudaStream_t)stream;
    if (d == 1) return fold_run<1>(p, fold, st);
    if (d == 2) return fold_run<2>(p, fold, st);
    if (d == 3) return fold_run<3>(p, fold, st);
    return (int)cudaErrorInvalidValue;
}
