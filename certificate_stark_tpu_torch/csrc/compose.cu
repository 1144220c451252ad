// The pointwise composition of the STARK prover: for each point x of a
// domain segment, H(x) = Z_t(x)^-1 * sum_c evals_c(x) (alpha_c + beta_c
// x^adj_c) plus, for each boundary divisor group g, Z_g(x)^-1 * sum_{a in
// g} (T_col_a(x) - B_a(x)) (alpha_a + beta_a x^adj_g); out [d, S], each
// product a base value times an extension coordinate (d = 1, 2, 3).
//
// Replaces certificate_stark_tpu/engine/prover.py `_pointwise_comp`
// (:628, XLA-fused on the TPU) and the port's own PyTorch composition.
// The template is native/deep_compose.c `f63_compose` (:127) with its
// flattened boundary layout, one point per thread, on f63.cuh. The plain
// version is ops/kernels.py `compose_plain`; the tables' layout is
// ops/kernels.py ComposeTables (flattened once per Prover).
//
// Bound on the H100: a point reads its C constraint values, the trace
// columns its assertions name, its x^adj, zerofier and divisor values, and
// writes d values; it does 2 d C + O(d (A + NA)) Montgomery multiplies. At
// the transaction AIR's C = 115 and 2^20 points that is ~1 GB against
// 10-30 G 32-bit multiplies: bound by bytes at d = 1, by the multiply
// rate at d = 3. What the design does:
// - one thread per point, neighbouring threads on neighbouring points:
//   every read of a table row or of a constraint's values coalesces;
// - the constraints come grouped by degree adjustment, so a point sums
//   evals_c beta_c over a group and multiplies by its x^adj once, reading
//   each x^adj row once (A rows, not C);
// - the coefficients and index tables are read at the same address by
//   every thread (broadcasts through the read-only cache);
// - the extension degree is a template parameter, so the accumulators
//   stay in registers.
#include <cuda_runtime.h>

#include "f63.cuh"

#define THREADS 256

__device__ __forceinline__ u64 msub(u64 a, u64 b) {
    return a >= b ? a - b : a + (F63_P - b);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
compose_kernel(const u64* __restrict__ evals, long long ev_ld, int C,
               const u64* __restrict__ cur, long long cur_ld,
               const long long* __restrict__ meta, int At, int NA, int G,
               const u64* __restrict__ xpow, const u64* __restrict__ zt_inv,
               const u64* __restrict__ b_invz, const u64* __restrict__ b_ev,
               long long ld, long long j0, const u64* __restrict__ ta,
               const u64* __restrict__ tb, const u64* __restrict__ ba,
               const u64* __restrict__ bb, int NB, long long S,
               u64* __restrict__ out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= S) return;
    const long long j = j0 + i;  // the point's index in the tables
    // meta: t_idx [C], t_start [At + 1], t_row [At], b_col, b_coef, b_row,
    // b_val [NA each], b_start [G + 1], b_adj [G]
    const long long* t_idx = meta;
    const long long* t_start = t_idx + C;
    const long long* t_row = t_start + At + 1;
    const long long* b_col = t_row + At;
    const long long* b_coef = b_col + NA;
    const long long* b_row = b_coef + NA;
    const long long* b_val = b_row + NA;
    const long long* b_start = b_val + NA;
    const long long* b_adj = b_start + G + 1;

    u64 acc[D];
#pragma unroll
    for (int e = 0; e < D; e++) acc[e] = 0;
    // transition constraints, a degree-adjustment group at a time
    for (int g = 0; g < At; g++) {
        u64 sb[D];
#pragma unroll
        for (int e = 0; e < D; e++) sb[e] = 0;
        const long long k1 = __ldg(t_start + g + 1);
        for (long long k = __ldg(t_start + g); k < k1; k++) {
            const long long c = __ldg(t_idx + k);
            const u64 v = __ldg(evals + c * ev_ld + i);
#pragma unroll
            for (int e = 0; e < D; e++) {
                acc[e] = f63_add(acc[e], f63_mmul(v, __ldg(ta + e * C + c)));
                sb[e] = f63_add(sb[e], f63_mmul(v, __ldg(tb + e * C + c)));
            }
        }
        const u64 x = __ldg(xpow + __ldg(t_row + g) * ld + j);
#pragma unroll
        for (int e = 0; e < D; e++) acc[e] = f63_add(acc[e], f63_mmul(sb[e], x));
    }
    const u64 z = __ldg(zt_inv + j);
#pragma unroll
    for (int e = 0; e < D; e++) acc[e] = f63_mmul(acc[e], z);
    // boundary terms, a divisor group at a time
    for (int g = 0; g < G; g++) {
        u64 sa[D], sb[D];
#pragma unroll
        for (int e = 0; e < D; e++) sa[e] = sb[e] = 0;
        const long long a1 = __ldg(b_start + g + 1);
        for (long long a = __ldg(b_start + g); a < a1; a++) {
            const long long r = __ldg(b_row + a);
            const u64 bev = r < 0 ? (u64)__ldg(b_val + a)
                                  : __ldg(b_ev + r * ld + j);
            const u64 num = msub(__ldg(cur + __ldg(b_col + a) * cur_ld + i),
                                 bev);
            const long long q = __ldg(b_coef + a);
#pragma unroll
            for (int e = 0; e < D; e++) {
                sa[e] = f63_add(sa[e], f63_mmul(num, __ldg(ba + e * NB + q)));
                sb[e] = f63_add(sb[e], f63_mmul(num, __ldg(bb + e * NB + q)));
            }
        }
        const u64 x = __ldg(xpow + __ldg(b_adj + g) * ld + j);
        const u64 iz = __ldg(b_invz + g * ld + j);
#pragma unroll
        for (int e = 0; e < D; e++)
            acc[e] = f63_add(acc[e],
                             f63_mmul(f63_add(sa[e], f63_mmul(sb[e], x)), iz));
    }
#pragma unroll
    for (int e = 0; e < D; e++) out[e * S + i] = acc[e];
}

// evals [C, S] (row stride ev_ld), the trace segment cur (row stride
// cur_ld), the ComposeTables meta and its counts, the domain tables xpow
// [A, ld], zt_inv [ld], b_invz [G, ld], b_ev [R, ld] read from point j0,
// the coefficients t_alpha, t_beta [d, C] and b_alpha, b_beta [d, NB];
// out [d, S] (all Montgomery u64 on the device).
extern "C" int compose_launch(const void* evals, long long ev_ld, int C,
                              const void* cur, long long cur_ld,
                              const void* meta, int At, int NA, int G,
                              const void* xpow, const void* zt_inv,
                              const void* b_invz, const void* b_ev,
                              long long ld, long long j0, const void* ta,
                              const void* tb, const void* ba, const void* bb,
                              int NB, int d, long long S, void* out,
                              void* stream) {
    if (S <= 0) return 0;
    const unsigned blocks = (unsigned)((S + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
#define COMPOSE_ARGS                                                        \
    (const u64*)evals, ev_ld, C, (const u64*)cur, cur_ld,                  \
        (const long long*)meta, At, NA, G, (const u64*)xpow,               \
        (const u64*)zt_inv, (const u64*)b_invz, (const u64*)b_ev, ld, j0,  \
        (const u64*)ta, (const u64*)tb, (const u64*)ba, (const u64*)bb, NB, \
        S, (u64*)out
    if (d == 1)
        compose_kernel<1><<<blocks, THREADS, 0, st>>>(COMPOSE_ARGS);
    else if (d == 2)
        compose_kernel<2><<<blocks, THREADS, 0, st>>>(COMPOSE_ARGS);
    else if (d == 3)
        compose_kernel<3><<<blocks, THREADS, 0, st>>>(COMPOSE_ARGS);
    else
        return (int)cudaErrorInvalidValue;
#undef COMPOSE_ARGS
    return (int)cudaGetLastError();
}
