// The pointwise composition of the STARK prover: for each point x of a
// domain segment, H(x) = Z_t(x)^-1 * sum_c evals_c(x) (alpha_c + beta_c
// x^adj_c) plus, for each boundary divisor group g, Z_g(x)^-1 * sum_{a in
// g} (T_col_a(x) - B_a(x)) (alpha_a + beta_a x^adj_g); out [d, S], each
// product a base value times an extension coordinate (d = 1, 2, 3).
//
// Replaces certificate_stark_tpu/engine/prover.py `_pointwise_comp`
// (:628, XLA-fused on the TPU) and the port's own PyTorch composition.
// The template is native/deep_compose.c `f63_compose` (:127) with its
// flattened boundary layout, on f63.cuh. The plain version is
// ops/kernels.py `compose_plain`; the tables' layout is ops/kernels.py
// ComposeTables (flattened once per Prover).
//
// Bound on the H100: a point reads its C constraint values, the trace
// columns its assertions name, its x^adj, zerofier and divisor values, and
// writes d values: at the transaction AIR's C = 115 and 2^20 points ~1 GB,
// 0.32 ms at 3.35 TB/s. Its products are 2 d a constraint and an
// assertion, d an adjustment group's x^adj, 2 d a boundary group's, and
// the zerofier's and divisors' d each: at d = 3 ~6k 32-bit multiplies a
// point as summed below, ~0.38 ms at 16.7 T/s. Every 32-bit integer
// instruction issues at the multiply rate on this card, so the count of
// instructions sets the time at d = 3; bytes set it at d = 1. What the
// design does:
// - sums of products stay unreduced: each base value times extension
//   coordinate goes into a `Wide` sum by four 32 x 32 + 64-bit
//   multiply-adds (wide_mac), and each sum is reduced once (wide_redc).
//   In Montgomery form the REDC of a sum is the sum of the REDCs mod p,
//   and every output is canonical, so the bits are the plain version's;
// - headroom: a fold leaves a sum's e part below (FOLD_TOP + 1) 2^96, and
//   FOLD_EVERY more products of canonical values, each adding at most
//   (p - 1)^2 to e, keep e + o 2^32 below 2^128. A group's items run
//   FOLD_EVERY at a time, unrolled with no branch, each run followed by a
//   fold of every sum (tests/test_torch_compose_words.py replays this
//   schedule in Python ints and checks the bounds);
// - a group's x^adj term is one more product into the alpha sum: the
//   group's beta sum reduced, times x^adj;
// - two adjacent points a thread, with 16-byte loads and stores where the
//   tensors allow it (the launcher checks), so each coefficient read from
//   shared memory serves two points and each load instruction two values;
//   the constraint values are read LOOKAHEAD items ahead;
// - the coefficients in group order, with each item's evaluation row
//   offset and the boundary tables, staged once a block in shared memory:
//   the inner loop has no indirection through the index tables and no
//   64-bit multiply; a persistent grid of the blocks an SM holds walks
//   over the points, so the staging is paid once a block, not once a
//   tile;
// - the extension degree is a template parameter, so the sums stay in
//   registers (Tuning sizes the blocks for them).
#include <cuda_runtime.h>

#include "f63.cuh"

#define LOOKAHEAD 2           // items read ahead of their use
static constexpr int P = 2;   // adjacent points a thread
// Threads a block and the resident blocks an SM the register allocation
// must allow (with 16-byte loads; the other path is the rare unaligned
// one). At d = 3 the two points' 12 sums alone take 84 registers and the
// thread ~165 in all: blocks of 128 threads, 3 an SM, hold that without
// spills (256 threads at 2 an SM spill, and take as long).
template <int D>
struct Tuning {
    static constexpr int threads = D == 3 ? 128 : 256;
    static constexpr int min_blocks = D == 3 ? 3 : 2;
};

// Two adjacent values: p[0] and p[1] in one 16-byte load (VEC), else
// p[0] and p[d1] (d1 = 0 for a lone last point).
template <bool VEC>
__device__ __forceinline__ void ldp(const u64* __restrict__ p, int d1,
                                    u64 v[P]) {
    if (VEC) {
        const ulonglong2 q = __ldg((const ulonglong2*)p);
        v[0] = q.x;
        v[1] = q.y;
    } else {
        v[0] = __ldg(p);
        v[1] = __ldg(p + d1);
    }
}

// The launch's arguments, one kernel parameter (in the constant bank: a
// pointer is formed where it is used, and none holds registers through
// the constraint loop).
struct Args {
    const u64* evals;  // [C, S], row stride ev_ld
    long long ev_ld;
    int C;
    const u64* cur;  // the trace segment, row stride cur_ld
    long long cur_ld;
    const long long* meta;  // ComposeTables meta, its counts At, NA, G
    int At, NA, G;
    // xpow [A, ld], zt_inv [ld], b_invz [G, ld], b_ev [R, ld], from j0
    const u64 *xpow, *zt_inv, *b_invz, *b_ev;
    long long ld, j0;
    // t_alpha, t_beta [d, C]; b_alpha, b_beta [d, NB]
    const u64 *ta, *tb, *ba, *bb;
    int NB;
    long long S;
    u64* out;  // [d, S]
};

// The block's staged tables (dynamic shared memory), in this order:
//   tco [C * D]   (t_alpha, t_beta) of item k's constraint, coordinate e
//   bco [NA * D]  (b_alpha, b_beta) of assertion a's coefficient column
//   toff [C + LOOKAHEAD]  item k's evals row offset in bytes (8 c_k
//                 ev_ld), then copies of the last, read by the look-ahead
//   tend [At]     the item after group g;  txo [At]  its x^adj row offset
//   bcur [NA]     assertion a's trace row offset (b_col cur_ld)
//   bevo [NA]     its b_ev row offset, or -1 for the constant bval [NA]
//   bend [G]      the assertion after group g;  bxo [G]  its x^adj row
//                 offset
struct Staged {
    const ulonglong2 *tco, *bco;
    const long long *toff, *tend, *txo, *bcur, *bevo, *bend, *bxo;
    const u64* bval;
};

static long long staged_bytes(int D, int C, int At, int NA, int G) {
    return 16LL * D * (C + NA) +
           8LL * ((C + LOOKAHEAD) + 2 * At + 3 * NA + 2 * G);
}

template <int D>
__device__ Staged stage(unsigned char* smem, const Args& p) {
    const int C = p.C, At = p.At, NA = p.NA, G = p.G, NB = p.NB;
    const long long ev_ld = p.ev_ld, cur_ld = p.cur_ld, ld = p.ld;
    const u64 *ta = p.ta, *tb = p.tb, *ba = p.ba, *bb = p.bb;
    // meta: t_idx [C], t_start [At + 1], t_row [At], b_col, b_coef, b_row,
    // b_val [NA each], b_start [G + 1], b_adj [G]
    const long long* t_idx = p.meta;
    const long long* t_start = t_idx + C;
    const long long* t_row = t_start + At + 1;
    const long long* b_col = t_row + At;
    const long long* b_coef = b_col + NA;
    const long long* b_row = b_coef + NA;
    const long long* b_val = b_row + NA;
    const long long* b_start = b_val + NA;
    const long long* b_adj = b_start + G + 1;

    ulonglong2* tco = (ulonglong2*)smem;
    ulonglong2* bco = tco + C * D;
    long long* toff = (long long*)(bco + NA * D);
    long long* tend = toff + C + LOOKAHEAD;
    long long* txo = tend + At;
    long long* bcur = txo + At;
    long long* bevo = bcur + NA;
    long long* bend = bevo + NA;
    long long* bxo = bend + G;
    u64* bval = (u64*)(bxo + G);
    const int t = threadIdx.x, T = Tuning<D>::threads;
    for (int q = t; q < C * D; q += T) {
        const int k = q / D, e = q % D;
        const long long c = __ldg(t_idx + k);
        tco[q] = make_ulonglong2(__ldg(ta + e * C + c), __ldg(tb + e * C + c));
    }
    for (int q = t; q < NA * D; q += T) {
        const int a = q / D, e = q % D;
        const long long c = __ldg(b_coef + a);
        bco[q] = make_ulonglong2(__ldg(ba + e * NB + c),
                                 __ldg(bb + e * NB + c));
    }
    for (int k = t; C > 0 && k < C + LOOKAHEAD; k += T)
        toff[k] = __ldg(t_idx + (k < C ? k : C - 1)) * ev_ld * 8;
    for (int g = t; g < At; g += T) {
        tend[g] = __ldg(t_start + g + 1);
        txo[g] = __ldg(t_row + g) * ld;
    }
    for (int a = t; a < NA; a += T) {
        const long long r = __ldg(b_row + a);
        bcur[a] = __ldg(b_col + a) * cur_ld;
        bevo[a] = r < 0 ? -1 : r * ld;
        bval[a] = (u64)__ldg(b_val + a);
    }
    for (int g = t; g < G; g += T) {
        bend[g] = __ldg(b_start + g + 1);
        bxo[g] = __ldg(b_adj + g) * ld;
    }
    __syncthreads();
    return Staged{tco, bco, toff, tend, txo, bcur, bevo, bend, bxo, bval};
}

template <int D>
__device__ __forceinline__ void zero_all(Wide w[P][D]) {
#pragma unroll
    for (int s = 0; s < P; s++)
#pragma unroll
        for (int e = 0; e < D; e++) wide_zero(w[s][e]);
}

template <int D>
__device__ __forceinline__ void fold_all(Wide w[P][D]) {
#pragma unroll
    for (int s = 0; s < P; s++)
#pragma unroll
        for (int e = 0; e < D; e++) wide_fold(w[s][e]);
}

// Two values of an item's row: base + the row's byte offset.
template <bool VEC>
__device__ __forceinline__ void ldp_at(const u64* __restrict__ base,
                                       long long bytes, int d1, u64 v[P]) {
    ldp<VEC>((const u64*)((const char*)base + bytes), d1, v);
}

// One transition item k: its values (read ahead) times its coefficients
// into both sums of each point; item k + LOOKAHEAD is read.
template <int D, bool VEC>
__device__ __forceinline__ void t_item(const Staged& st,
                                       const u64* __restrict__ ev, int d1,
                                       int k, u64 (&ahead)[LOOKAHEAD][P],
                                       Wide (&sa)[P][D], Wide (&sb)[P][D]) {
    u64 v[P];
#pragma unroll
    for (int s = 0; s < P; s++) v[s] = ahead[0][s];
#pragma unroll
    for (int q = 0; q + 1 < LOOKAHEAD; q++)
#pragma unroll
        for (int s = 0; s < P; s++) ahead[q][s] = ahead[q + 1][s];
    ldp_at<VEC>(ev, st.toff[k + LOOKAHEAD], d1, ahead[LOOKAHEAD - 1]);
    const ulonglong2* co = st.tco + k * D;
#pragma unroll
    for (int e = 0; e < D; e++) {
        const ulonglong2 ab = co[e];
#pragma unroll
        for (int s = 0; s < P; s++) {
            wide_mac(sa[s][e], v[s], ab.x);
            wide_mac(sb[s][e], v[s], ab.y);
        }
    }
}

// One assertion a: (trace value - boundary value) times its coefficients
// into both sums of each point.
template <int D, bool VEC>
__device__ __forceinline__ void b_item(const Staged& st,
                                       const u64* __restrict__ cu,
                                       const u64* __restrict__ bev_tab,
                                       int d1, int a, Wide (&sa)[P][D],
                                       Wide (&sb)[P][D]) {
    u64 c[P], b[P], num[P];
    ldp<VEC>(cu + st.bcur[a], d1, c);
    const long long r = st.bevo[a];
    if (r < 0) {
#pragma unroll
        for (int s = 0; s < P; s++) b[s] = st.bval[a];
    } else {
        ldp<VEC>(bev_tab + r, d1, b);
    }
#pragma unroll
    for (int s = 0; s < P; s++) num[s] = msub(c[s], b[s]);
    const ulonglong2* co = st.bco + a * D;
#pragma unroll
    for (int e = 0; e < D; e++) {
        const ulonglong2 ab = co[e];
#pragma unroll
        for (int s = 0; s < P; s++) {
            wide_mac(sa[s][e], num[s], ab.x);
            wide_mac(sb[s][e], num[s], ab.y);
        }
    }
}

// H at the points i and i + 1 (i alone if it is the last); out [d, S] at
// i. Each
// sum is folded after every FOLD_EVERY items of a group, and the alpha
// sum after each group's x^adj product, so no sum takes more than
// FOLD_EVERY products between two folds: a group's last items (fewer
// than FOLD_EVERY) and its x^adj product.
template <int D, bool VEC>
__device__ __forceinline__ void compose_pair(const Staged& st, const Args& p,
                                             long long i) {
    const bool both = i + 1 < p.S;
    const int d1 = VEC || both ? 1 : 0;
    const long long j = p.j0 + i;
    const u64* __restrict__ ev = p.evals + i;
    Wide sa[P][D], sb[P][D];  // the alpha and beta sums, unreduced
    zero_all<D>(sa);
    // transition constraints, a degree-adjustment group at a time
    if (p.C > 0) {
        u64 ahead[LOOKAHEAD][P];  // the values of items k, k + 1, ...
#pragma unroll
        for (int q = 0; q < LOOKAHEAD; q++)
            ldp_at<VEC>(ev, st.toff[q], d1, ahead[q]);
        int k = 0;
        for (int g = 0; g < p.At; g++) {
            zero_all<D>(sb);
            const int k1 = (int)st.tend[g];
#pragma unroll 1
            for (; k + FOLD_EVERY <= k1; k += FOLD_EVERY) {
#pragma unroll
                for (int q = 0; q < FOLD_EVERY; q++)
                    t_item<D, VEC>(st, ev, d1, k + q, ahead, sa, sb);
                fold_all<D>(sa);
                fold_all<D>(sb);
            }
#pragma unroll 1
            for (; k < k1; k++) t_item<D, VEC>(st, ev, d1, k, ahead, sa, sb);
            u64 x[P];
            ldp<VEC>(p.xpow + j + st.txo[g], d1, x);
#pragma unroll
            for (int e = 0; e < D; e++)
#pragma unroll
                for (int s = 0; s < P; s++)
                    wide_mac(sa[s][e], wide_redc(sb[s][e]), x[s]);
            fold_all<D>(sa);
        }
    }
    u64 acc[P][D], z[P];
    ldp<VEC>(p.zt_inv + j, d1, z);
#pragma unroll
    for (int e = 0; e < D; e++)
#pragma unroll
        for (int s = 0; s < P; s++)
            acc[s][e] = f63_mmul(wide_redc(sa[s][e]), z[s]);
    // boundary terms, a divisor group at a time
    int a = 0;
    for (int g = 0; g < p.G; g++) {
        zero_all<D>(sa);
        zero_all<D>(sb);
        const int a1 = (int)st.bend[g];
#pragma unroll 1
        for (; a + FOLD_EVERY <= a1; a += FOLD_EVERY) {
#pragma unroll 1
            for (int q = 0; q < FOLD_EVERY; q++)
                b_item<D, VEC>(st, p.cur + i, p.b_ev + j, d1, a + q, sa, sb);
            fold_all<D>(sa);
            fold_all<D>(sb);
        }
#pragma unroll 1
        for (; a < a1; a++)
            b_item<D, VEC>(st, p.cur + i, p.b_ev + j, d1, a, sa, sb);
        u64 x[P], iz[P];
        ldp<VEC>(p.xpow + j + st.bxo[g], d1, x);
        ldp<VEC>(p.b_invz + j + g * p.ld, d1, iz);
#pragma unroll
        for (int e = 0; e < D; e++)
#pragma unroll
            for (int s = 0; s < P; s++) {
                wide_mac(sa[s][e], wide_redc(sb[s][e]), x[s]);
                acc[s][e] = f63_add(
                    acc[s][e], f63_mmul(wide_redc(sa[s][e]), iz[s]));
            }
    }
#pragma unroll
    for (int e = 0; e < D; e++) {
        u64* o = p.out + e * p.S + i;
        if (VEC) {
            *(ulonglong2*)o = make_ulonglong2(acc[0][e], acc[1][e]);
        } else {
            o[0] = acc[0][e];
            if (both) o[1] = acc[1][e];
        }
    }
}

template <int D, bool VEC>
__global__ void __launch_bounds__(Tuning<D>::threads,
                                  VEC ? Tuning<D>::min_blocks : 1)
compose_kernel(const __grid_constant__ Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int T = Tuning<D>::threads;
    const Staged st = stage<D>(smem, p);
    const long long units = (p.S + P - 1) / P;
    for (long long q = (long long)blockIdx.x * T + threadIdx.x; q < units;
         q += (long long)gridDim.x * T)
        compose_pair<D, VEC>(st, p, P * q);
}

// The launch shape: dynamic shared memory a block, resident blocks an SM
// and the persistent grid (at most that many blocks on every SM, fewer
// for a short segment).
template <int D, bool VEC>
static cudaError_t grid_of(int C, int At, int NA, int G, long long S,
                           int* smem, int* blocks_per_sm, int* grid) {
    constexpr int T = Tuning<D>::threads;
    *smem = (int)staged_bytes(D, C, At, NA, G);
    cudaError_t e = cudaSuccess;
    if (*smem > 48 * 1024)
        e = cudaFuncSetAttribute(compose_kernel<D, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 *smem);
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, compose_kernel<D, VEC>, T, *smem);
    if (e != cudaSuccess) return e;
    if (*blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long need = ((S + P - 1) / P + T - 1) / T;
    const long long most = (long long)*blocks_per_sm * sms;
    *grid = (int)(need < most ? need : most);
    return cudaSuccess;
}

template <int D, bool VEC>
static int launch(const Args& p, cudaStream_t st) {
    int smem, per_sm, grid;
    const cudaError_t e = grid_of<D, VEC>(p.C, p.At, p.NA, p.G, p.S, &smem,
                                          &per_sm, &grid);
    if (e != cudaSuccess) return (int)e;
    constexpr int T = Tuning<D>::threads;
    compose_kernel<D, VEC><<<grid, T, smem, st>>>(p);
    return (int)cudaGetLastError();
}

// Whether every row the kernel reads two points at a time from, and out,
// is 16-byte aligned at even points: S, j0 and the row strides even, the
// pointers 16-byte aligned.
static bool vec_ok(const void* evals, long long ev_ld, const void* cur,
                   long long cur_ld, const void* xpow, const void* zt_inv,
                   const void* b_invz, const void* b_ev, long long ld,
                   long long j0, const void* out, long long S) {
    unsigned long long bits = (unsigned long long)ev_ld |
                              (unsigned long long)cur_ld |
                              (unsigned long long)ld |
                              (unsigned long long)j0 | (unsigned long long)S;
    const void* ptrs[] = {evals, cur, xpow, zt_inv, b_invz, b_ev, out};
    for (const void* p : ptrs) bits |= (unsigned long long)p >> 3;
    return (bits & 1) == 0;
}

// evals [C, S] (row stride ev_ld), the trace segment cur (row stride
// cur_ld), the ComposeTables meta and its counts, the domain tables xpow
// [A, ld], zt_inv [ld], b_invz [G, ld], b_ev [R, ld] read from point j0,
// the coefficients t_alpha, t_beta [d, C] and b_alpha, b_beta [d, NB];
// out [d, S] (all Montgomery u64 on the device, 8-byte aligned).
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
    if (C + At > MAX_TERMS || NA + G > MAX_TERMS)
        return (int)cudaErrorInvalidValue;
    const bool vec = vec_ok(evals, ev_ld, cur, cur_ld, xpow, zt_inv, b_invz,
                            b_ev, ld, j0, out, S);
    const Args p = {(const u64*)evals, ev_ld, C, (const u64*)cur, cur_ld,
                    (const long long*)meta, At, NA, G, (const u64*)xpow,
                    (const u64*)zt_inv, (const u64*)b_invz, (const u64*)b_ev,
                    ld, j0, (const u64*)ta, (const u64*)tb, (const u64*)ba,
                    (const u64*)bb, NB, S, (u64*)out};
    const cudaStream_t st = (cudaStream_t)stream;
    if (d == 1) return vec ? launch<1, true>(p, st) : launch<1, false>(p, st);
    if (d == 2) return vec ? launch<2, true>(p, st) : launch<2, false>(p, st);
    if (d == 3) return vec ? launch<3, true>(p, st) : launch<3, false>(p, st);
    return (int)cudaErrorInvalidValue;
}

// The launch shape compose_launch takes for these counts on the current
// card with 16-byte loads (the prover's aligned rows): dynamic shared
// memory a block, resident blocks an SM, blocks in the grid.
extern "C" int compose_occupancy(int C, int At, int NA, int G, int d,
                                 long long S, int* smem, int* blocks_per_sm,
                                 int* grid) {
#define SHAPE_ARGS C, At, NA, G, S, smem, blocks_per_sm, grid
    cudaError_t e = cudaErrorInvalidValue;
    if (d == 1) e = grid_of<1, true>(SHAPE_ARGS);
    if (d == 2) e = grid_of<2, true>(SHAPE_ARGS);
    if (d == 3) e = grid_of<3, true>(SHAPE_ARGS);
#undef SHAPE_ARGS
    return (int)e;
}
