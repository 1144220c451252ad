// The proof's tail of the STARK prover, from the out-of-domain point to
// the FRI fold, in the extension of degree D = 1, 2, 3 (x^2 = 3; x^3 =
// 3x + 1: params/extensions.py), as three kernels:
//
//   ood       sum_i c_i p^(s + i) of every trace column at p = z and z g
//             and of every composition column at z^k (three launches: the
//             powers' tables, a block's strips of indices, then the blocks'
//             partial sums);
//   deep      sum_j g_z,j (f_j(x) - f_j(z)) / (x - z) + the same at z g
//             + sum_j g_h,j (H_j(x) - H_j(z^k)) / (x - z^k) on a domain
//             segment (a block first sums sum_j g_j f_j(p) at the three
//             points, the terms that do not depend on x);
//   fri_fold  one FRI layer's fold by 2 or 4 in registers, written as the
//             folded values or straight into the next layer's leaf rows.
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
// operations a second, 1,979 T int8 tensor-core operations a second):
// - ood reads the w trace and d k composition coefficient columns once:
//   at w = 94, m = 2^20 ~0.99 GB (0.30 ms). Its sums of products run on
//   the int8 tensor cores as byte-sliced exact integer products (below);
//   the powers of the three points come from a table of p^r (r < a strip)
//   and one start power a strip, one extension multiply an index and
//   point;
// - deep reads w trace values and d k composition values a point and
//   writes d: at w = 94, d = 3, 2^20 points ~1 GB (0.30 ms). Its two
//   multiply-sums (the trace's, with constant coefficients g, and the
//   composition's) run on the tensor cores too, from the trace tile
//   streamed into shared memory by cp.async; the CUDA cores keep the rest
//   of a point: the three denominators and their product as polynomials
//   in x with constant coefficients, the numerator summed unreduced
//   (Wide, f63.cuh), the denominator's adjugate and norm, and Montgomery's
//   trick over the norms of a thread's run of DeepRun<D>::R points: one
//   base-field inversion a run (66 squarings, 16 multiplies). A zero
//   denominator is replaced by 1 before the product and its point written
//   0, the rule of F.batch_inv;
// - fri_fold reads fold d values and writes d a point: bytes bound it at
//   every d by the count of multiplies (4 d + 3 Montgomery multiplies and
//   three extension multiplies by constants a point at fold 4), but at
//   d = 3 its integer instructions a point take longer, issued at the
//   multiply rate. 1/x comes from a split table (lo[e mod 2^h] hi[e >> h]
//   = (o w^e)^-1).
//
// Byte-sliced products. A sum V = sum_K u_K v_K of canonical values (each
// below p < 2^63, its top byte at most 0x41) is the exact integer
// sum_{a,b} C[a][b] 2^(8(a + b)) with C[a][b] = sum_K byte_a(u_K)
// byte_b(v_K): a u8 x u8 -> s32 matrix product with the bytes a in the
// rows and the bytes b in the columns (mma.sync m16n8k32, the simpler
// route: warp-synchronous, fragments in registers, no descriptors; the
// operands here are a few KB and wgmma's 64-row tiles would not fill).
// V is then reduced as wide_redc reduces the same sum, to V 2^-64 mod p,
// so the bits cannot change. The layout ("transposed": K over the terms):
// - A, the streamed operand (a point's trace values in deep, a column's
//   coefficients in ood): m-tile u of a group holds rows g = (item g,
//   byte 2u) and g + 8 = (item g, byte 2u + 1), so the four m-tiles of a
//   group cover all eight bytes of eight items. Lane (g, t) supplies item
//   g at its eight K slots m: slots 0..3 are K = 4t .. 4t + 3, slots 4..7
//   K = 16 + 4t .. 16 + 4t + 3 (the m16n8k32 fragment); its registers come
//   from its eight 64-bit values by 4 x 4 byte transposes (prmt).
// - B, the constant operand (deep's coefficients g, ood's powers): n-tile
//   v is one sum, its column b is byte b; lane (g, t) holds 8 bytes, byte
//   m = byte g of the term at its K slot m, prepared once a block (deep)
//   or a strip (ood) in shared memory in fragment order.
// - C: lane (g, t) of n-tile v holds C[2u][2t], C[2u][2t + 1], C[2u + 1]
//   [2t], C[2u + 1][2t + 1] of item g for each u: a quarter of the bytes b
//   for all a, its share X_t = sum_a 2^(8a) (C[a][2t] + 2^8 C[a][2t + 1])
//   of V = sum_t 2^(16t) X_t. The quad adds its shares exactly in two
//   exchanges that split the sums between the lanes (quad_sums: lane t
//   ends with sum 4j + t), folds the bits above 2^126 by 2^126 mod p and
//   reduces once.
// Exactness, each bound beside the code that depends on it:
// - a C entry sums at most MAX_U8_TERMS products of two bytes, each at
//   most 255^2: 255^2 * 33,025 = 2,147,450,625 < 2^31, so the s32
//   accumulators never wrap (deep: w trace terms, d k composition terms;
//   ood: OOD_STRIP indices);
// - in share_x(): y_u < 66,049 * 2^31 < 2^47.02, y_0 + 2^16 y_1 <
//   2^63.02, X_t < 2^95.03; in quad_sums(): X_0 + 2^16 X_1 < 2^111.04,
//   V < 2^143.05, and with its bits from 2^126 folded V' < 2^126 + 2^80.06
//   < p 2^64, within f63_redc's range.
// tests/test_torch_deep_bytes.py replays this arithmetic in Python ints,
// fragment for fragment, and reads the constants below.
#include <cuda_runtime.h>

#include "f63.cuh"

#define MAX_U8_TERMS 33025            // terms of one s32 sum of byte products
#define OOD_THREADS 128
#define OOD_WARPS (OOD_THREADS / 32)
#define OOD_STRIP 512                 // a strip's most indices:
#define OOD_KSTEPS (OOD_STRIP / 32)   // ops/kernels.py OOD_STRIP
#define DEEP_WARPS 4
#define DEEP_THREADS (32 * DEEP_WARPS)
#define DEEP_STAGES 4                 // a block's ring of staged chunks
#define DEEP_ROW 272                  // bytes a staged row: 32 points + pad
#define DEEP_CHUNK (32 * DEEP_ROW)    // a chunk: 32 rows of 32 points
// the widest trace and composition deep takes (ops/kernels.py DEEP_MAX_W,
// DEEP_MAX_K): a block's B fragments stay in shared memory (24 KB for
// 512 columns at d = 3), well inside MAX_U8_TERMS
#define DEEP_MAX_W 512
#define DEEP_MAX_K 32
#define FOLD_THREADS 256

static_assert(255 * 255 * (long long)MAX_U8_TERMS < (1LL << 31),
              "a C entry of MAX_U8_TERMS byte products fits in s32");
static_assert(OOD_STRIP <= MAX_U8_TERMS && DEEP_MAX_W <= MAX_U8_TERMS &&
                  3 * DEEP_MAX_K <= MAX_U8_TERMS,
              "every s32 sum within MAX_U8_TERMS terms");

// DEEP's points a thread (its run for Montgomery's trick): a round of a
// block is up to R sub-rounds of 128 points, one a thread each.
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

// The norm of a (D >= 2; a base-field value, 0 only for a = 0) and the
// adjugate adj with a adj = norm, so 1 / a = adj / norm, as
// ops/extfield.py `ext_inv_vec` takes them.
template <int D>
__device__ __forceinline__ u64 ext_adj_norm(const u64 (&a)[D], u64 (&adj)[D]) {
    static_assert(D == 2 || D == 3, "an extension of degree 2 or 3");
    if constexpr (D == 2) {
        adj[0] = a[0];
        adj[1] = msub(0, a[1]);
        return msub(f63_msqr(a[0]), mtriple(f63_msqr(a[1])));
    } else {
        // the multiplication matrix [[a0, m12, m13], [a1, m11, m23],
        // [a2, a1, m11]]; its first row's cofactors and the determinant
        const u64 a0 = a[0], a1 = a[1], a2 = a[2];
        const u64 m11 = f63_add(a0, mtriple(a2)), m12 = a2, m13 = a1;
        const u64 m23 = f63_add(m12, mtriple(a1));
        adj[0] = msub(f63_msqr(m11), f63_mmul(m23, a1));
        adj[1] = msub(f63_mmul(m23, a2), f63_mmul(a1, m11));
        adj[2] = msub(f63_msqr(a1), f63_mmul(m11, a2));
        return f63_add(f63_add(f63_mmul(a0, adj[0]), f63_mmul(m12, adj[1])),
                       f63_mmul(m13, adj[2]));
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

// ---- byte-sliced products on the tensor cores ------------------------------
// r[a] = byte a of x0, x1, x2, x3 (byte i of r[a] from x_i).
__device__ __forceinline__ void bytes4x4(u32 x0, u32 x1, u32 x2, u32 x3,
                                         u32 (&r)[4]) {
    const u32 t0 = __byte_perm(x0, x1, 0x5140);  // x0.0 x1.0 x0.1 x1.1
    const u32 t1 = __byte_perm(x0, x1, 0x7362);  // x0.2 x1.2 x0.3 x1.3
    const u32 t2 = __byte_perm(x2, x3, 0x5140);
    const u32 t3 = __byte_perm(x2, x3, 0x7362);
    r[0] = __byte_perm(t0, t2, 0x5410);
    r[1] = __byte_perm(t0, t2, 0x7632);
    r[2] = __byte_perm(t1, t3, 0x5410);
    r[3] = __byte_perm(t1, t3, 0x7632);
}

// o[g] = the 64-bit word whose byte m is byte g of x[m].
__device__ __forceinline__ void bytes8x8(const u64 (&x)[8], u64 (&o)[8]) {
    u32 a[4], b[4], c[4], d[4];
    bytes4x4(lo32(x[0]), lo32(x[1]), lo32(x[2]), lo32(x[3]), a);
    bytes4x4(lo32(x[4]), lo32(x[5]), lo32(x[6]), lo32(x[7]), b);
    bytes4x4(hi32(x[0]), hi32(x[1]), hi32(x[2]), hi32(x[3]), c);
    bytes4x4(hi32(x[4]), hi32(x[5]), hi32(x[6]), hi32(x[7]), d);
#pragma unroll
    for (int g = 0; g < 4; g++) {
        o[g] = join32(a[g], b[g]);
        o[g + 4] = join32(c[g], d[g]);
    }
}

// The A fragments of a group's four m-tiles from a lane's eight values at
// its K slots: m-tile u takes bytes 2u (rows g) and 2u + 1 (rows g + 8)
// of slots 0..3 (registers 0, 1) and of slots 4..7 (registers 2, 3).
__device__ __forceinline__ void a_frags(const u64 (&v)[8], u32 (&A)[4][4]) {
    u32 l0[4], h0[4], l1[4], h1[4];
    bytes4x4(lo32(v[0]), lo32(v[1]), lo32(v[2]), lo32(v[3]), l0);
    bytes4x4(hi32(v[0]), hi32(v[1]), hi32(v[2]), hi32(v[3]), h0);
    bytes4x4(lo32(v[4]), lo32(v[5]), lo32(v[6]), lo32(v[7]), l1);
    bytes4x4(hi32(v[4]), hi32(v[5]), hi32(v[6]), hi32(v[7]), h1);
#pragma unroll
    for (int u = 0; u < 2; u++) {
        A[u][0] = l0[2 * u];
        A[u][1] = l0[2 * u + 1];
        A[u][2] = l1[2 * u];
        A[u][3] = l1[2 * u + 1];
        A[u + 2][0] = h0[2 * u];
        A[u + 2][1] = h0[2 * u + 1];
        A[u + 2][2] = h1[2 * u];
        A[u + 2][3] = h1[2 * u + 1];
    }
}

// c += A B on the int8 tensor cores (u8 x u8, exact s32 sums); b holds the
// two B registers (low word: K 4t .. 4t + 3, high word: 16 + 4t ..).
__device__ __forceinline__ void mma_u8(int (&c)[4], const u32 (&a)[4],
                                       u64 b) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo32(b)),
          "r"(hi32(b)));
}

#define F63_C126 3268719485270127941ULL  // 2^126 mod p

// The lane's share of the sum of n-tile v: from c[u] = (C[2u][2t],
// C[2u][2t + 1], C[2u + 1][2t], C[2u + 1][2t + 1]) the exact X_t =
// sum_u 2^(16u) y_u, y_u = c0 + 2^8 (c1 + c2) + 2^16 c3, as its low 64
// bits xl and the bits above, xh. Each entry is below 2^31
// (MAX_U8_TERMS), so c1 + c2 < 2^32, y_u < 66,049 * 2^31 < 2^47.02,
// y_0 + 2^16 y_1 < 2^63.02 (no wrap) and X_t < 2^95.03 (xh < 2^31.03).
template <int N>
__device__ __forceinline__ void share_x(const int (&acc)[4][N][4], int v,
                                        u64& xl, u32& xh) {
    u64 y[4];
#pragma unroll
    for (int u = 0; u < 4; u++)
        y[u] = (u64)(u32)acc[u][v][0] +
               ((u64)((u32)acc[u][v][1] + (u32)acc[u][v][2]) << 8) +
               ((u64)(u32)acc[u][v][3] << 16);
    const u64 lo = y[0] + (y[1] << 16), hi = y[2] + (y[3] << 16);
    xl = lo + (hi << 32);  // X = lo + hi 2^32
    xh = hi32(hi) + (xl < lo);
}

// The quad's sums of its N n-tiles, exact, then reduced: lane t ends with
// sum 4j + t in out[j] (V 2^-64 mod p, canonical; 0 past N). First the
// lanes t, t ^ 1 trade the shares of the sums the other keeps (t odd
// keeps the odd sums): Y = X_even + 2^16 X_odd < 2^111.04, two words
// with yh < 2^47.04. Then t, t ^ 2 the same for the Y's: V = Y_(t < 2) +
// 2^32 Y_(t >= 2) < 2^143.05, three words. Its bits from 2^126 (below
// 2^17.05) come back times 2^126 mod p (< 2^80.06), leaving V' < 2^126 +
// 2^80.06 < p 2^64: one REDC.
template <int N>
__device__ __forceinline__ void quad_sums(const int (&acc)[4][N][4],
                                          u64 (&out)[(N + 3) / 4]) {
    constexpr int Q = (N + 3) / 4;
    const int lane = threadIdx.x & 31, odd = lane & 1, up = (lane >> 1) & 1;
    u64 yl[2 * Q], yh[2 * Q];
#pragma unroll
    for (int i = 0; i < 2 * Q; i++) {
        u64 al = 0, bl = 0;
        u32 ah = 0, bh = 0;
        if (2 * i < N) share_x<N>(acc, 2 * i, al, ah);
        if (2 * i + 1 < N) share_x<N>(acc, 2 * i + 1, bl, bh);
        const u64 rl = __shfl_xor_sync(0xffffffffu, odd ? al : bl, 1);
        const u32 rh = __shfl_xor_sync(0xffffffffu, odd ? ah : bh, 1);
        const u64 ol = odd ? bl : al;
        const u32 oh = odd ? bh : ah;
        const u64 el = odd ? rl : ol, dl = odd ? ol : rl;  // X_even, X_odd
        const u32 eh = odd ? rh : oh, dh = odd ? oh : rh;
        yl[i] = el + (dl << 16);
        yh[i] = (u64)eh + ((u64)dh << 16) + (dl >> 48) + (yl[i] < el);
    }
#pragma unroll
    for (int j = 0; j < Q; j++) {
        const u64 sl = up ? yl[2 * j] : yl[2 * j + 1];
        const u64 sh = up ? yh[2 * j] : yh[2 * j + 1];
        const u64 rl = __shfl_xor_sync(0xffffffffu, sl, 2);
        const u64 rh = __shfl_xor_sync(0xffffffffu, sh, 2);
        const u64 ol = up ? yl[2 * j + 1] : yl[2 * j];
        const u64 oh = up ? yh[2 * j + 1] : yh[2 * j];
        const u64 ll = up ? rl : ol, lh = up ? rh : oh;  // lanes t < 2
        const u64 hl = up ? ol : rl, hh = up ? oh : rh;  // lanes t >= 2
        const u64 z0 = ll + (hl << 32);
        const u64 tz = lh + (hl >> 32) + (z0 < ll);
        const u64 z1 = tz + (hh << 32);
        const u64 z2 = (hh >> 32) + (z1 < tz);
        const u64 top = (z2 << 2) | (z1 >> 62);  // V's bits from 2^126
        const u64 w0 = z0 + top * F63_C126;
        const u64 w1 = (z1 & ((1ULL << 62) - 1)) +
                       __umul64hi(top, F63_C126) + (w0 < z0);
        out[j] = f63_redc(lo32(w0), hi32(w0), lo32(w1), hi32(w1));
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    const u32 d = (u32)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const u32 d = (u32)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// ---- ood -------------------------------------------------------------------
struct OodArgs {
    const u64* coef;  // trace coefficients [w, m], row stride c_ld
    long long c_ld;
    int w;
    const u64* h;  // composition coefficients: coordinate e of column c at
    long long h_le, h_lc;  // index i is h[e h_le + c h_lc + i]
    int k;
    long long m, strips;
    int L;            // a strip's indices, a multiple of 32, <= OOD_STRIP
    const u64* tpow;  // [3][D][OOD_STRIP]: p_q^r (r < L)
    const u64* spow;  // [strips][3][D]: p_q^(s + strip L)
    u64* part;        // [grid <= rows][V], V = 2 D w + D^2 k
    long long rows;
    int al16;         // every row 16-byte aligned
};

// The tables of the powers: p_q^r for r < L, and each strip's first
// power p_q^(s + strip L), one square-and-multiply a thread; pts [D, 3] =
// (z, z g, z^k).
template <int D>
__global__ void __launch_bounds__(256)
ood_pow_kernel(const u64* __restrict__ pts, unsigned long long s,
               long long strips, int L, u64* __restrict__ tpow,
               u64* __restrict__ spow) {
    const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
    const long long nt = 3LL * L;
    if (i >= nt + 3 * strips) return;
    int q;
    unsigned long long e;
    u64* dst;
    long long ld;
    if (i < nt) {
        q = (int)(i / L);
        e = (unsigned long long)(i % L);
        dst = tpow + (long long)q * D * OOD_STRIP + e;
        ld = OOD_STRIP;
    } else {
        const long long sg = (i - nt) / 3;
        q = (int)((i - nt) % 3);
        e = s + (unsigned long long)sg * L;
        dst = spow + (sg * 3 + q) * D;
        ld = 1;
    }
    u64 b[D], r[D];
#pragma unroll
    for (int c = 0; c < D; c++) b[c] = __ldg(pts + c * 3 + q);
    ext_pow<D>(b, e, r);
#pragma unroll
    for (int c = 0; c < D; c++) dst[c * ld] = r[c];
}

// A lane's 8 coefficients of its row at indices i .. i + 7 (0 past m).
__device__ __forceinline__ void ood_load(const u64* row, long long i,
                                         long long m, int al16,
                                         u64 (&v)[8]) {
    if (row != nullptr && i + 8 <= m && al16) {
#pragma unroll
        for (int q = 0; q < 4; q++) {
            const ulonglong2 x = __ldg((const ulonglong2*)(row + i) + q);
            v[2 * q] = x.x;
            v[2 * q + 1] = x.y;
        }
    } else {
#pragma unroll
        for (int q = 0; q < 8; q++)
            v[q] = row != nullptr && i + q < m ? __ldg(row + i + q) : 0;
    }
}

// A warp's row group over the strip [i0, i0 + L): lane (g, t)
// reads row g's coefficients at the indices i0 + 32 kappa + 8t + m (its K
// slot m of k-step kappa; row null: a pad row), the next k-step's loaded
// while this one multiplies; n-tiles nb .. nb + NT - 1 of the strip's
// power fragments bf. Then each n-tile's sum (quad_sums), written by lane
// t = v mod 4 into dst[v dld] (added to it after the block's first
// strip).
template <int D, int NT>
__device__ __forceinline__ void ood_rows(const OodArgs& p,
                                         const u64 (*bf)[3 * D][32], int nb,
                                         const u64* row, long long i0,
                                         u64* dst, long long dld,
                                         bool first) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    int acc[4][NT][4];
#pragma unroll
    for (int u = 0; u < 4; u++)
#pragma unroll
        for (int v = 0; v < NT; v++)
#pragma unroll
            for (int c = 0; c < 4; c++) acc[u][v][c] = 0;
    u64 nx[8];
    ood_load(row, i0 + 8 * t, p.m, p.al16, nx);
#pragma unroll 1
    for (int kappa = 0; kappa < p.L / 32; kappa++) {
        u32 A[4][4];
        a_frags(nx, A);
        if (kappa + 1 < p.L / 32)
            ood_load(row, i0 + 32 * (kappa + 1) + 8 * t, p.m, p.al16, nx);
#pragma unroll
        for (int v = 0; v < NT; v++) {
            const u64 b = bf[kappa][nb + v][lane];
#pragma unroll
            for (int u = 0; u < 4; u++) mma_u8(acc[u][v], A[u], b);
        }
    }
    u64 s[(NT + 3) / 4];
    quad_sums<NT>(acc, s);
#pragma unroll
    for (int j = 0; j < (NT + 3) / 4; j++) {
        const int v = 4 * j + t;
        if (row != nullptr && v < NT)
            dst[v * dld] = first ? s[j] : f63_add(dst[v * dld], s[j]);
    }
}

// A persistent block's strips (blockIdx.x, then every gridDim.x-th): the
// strip's powers p_q^(i0 + r) = (start power) p_q^r as B fragments in
// shared memory (n-tile (q, e), k-step kappa: lane (g, t) byte m = byte g
// of coordinate e of the power at index i0 + 32 kappa + 8t + m), then a
// warp a row group of 8: trace columns against z and z g, composition
// rows (e1, c) against z^k. The block's partial sums stay in its row of
// part: trace column j, n-tile q D + e at (q D + e) w + j; composition
// row (e1, c), coordinate e2 of the power at 2 D w + (e1 k + c) D + e2.
template <int D>
__global__ void __launch_bounds__(OOD_THREADS, 3)
ood_kernel(const __grid_constant__ OodArgs p) {
    __shared__ u64 bf[OOD_KSTEPS][3 * D][32];
    const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
    const int w = p.w, nk = D * p.k;
    const int rgt = (w + 7) / 8, rgc = (nk + 7) / 8;
    u64* part = p.part + (long long)blockIdx.x * (2LL * D * w + D * nk);
    bool first = true;
    for (long long sg = blockIdx.x; sg < p.strips; sg += gridDim.x) {
        const long long i0 = sg * p.L;
        __syncthreads();  // the previous strip's fragments are read
        for (int u = tid; u < 3 * p.L / 8; u += OOD_THREADS) {
            const int q = u / (p.L / 8), r8 = u % (p.L / 8);
            u64 st[D], pw[D][8];
#pragma unroll
            for (int e = 0; e < D; e++)
                st[e] = __ldg(p.spow + (sg * 3 + q) * D + e);
#pragma unroll
            for (int m = 0; m < 8; m++) {
                u64 tv[D], r[D];
#pragma unroll
                for (int e = 0; e < D; e++)
                    tv[e] = __ldg(p.tpow + (q * D + e) * OOD_STRIP + 8 * r8 +
                                  m);
                ext_mul<D>(st, tv, r);
#pragma unroll
                for (int e = 0; e < D; e++) pw[e][m] = r[e];
            }
#pragma unroll
            for (int e = 0; e < D; e++) {
                u64 f[8];
                bytes8x8(pw[e], f);
#pragma unroll
                for (int gg = 0; gg < 8; gg++)
                    bf[r8 >> 2][q * D + e][4 * gg + (r8 & 3)] = f[gg];
            }
        }
        __syncthreads();
        for (int rg = warp; rg < rgt + rgc; rg += OOD_WARPS) {
            if (rg < rgt) {
                const int j = 8 * rg + g;
                ood_rows<D, 2 * D>(p, bf, 0,
                                   j < w ? p.coef + j * p.c_ld : nullptr, i0,
                                   part + j, w, first);
            } else {
                // composition row rc: (e1, c) = (rc / k, rc mod k)
                const int rc = 8 * (rg - rgt) + g;
                ood_rows<D, D>(p, bf, 2 * D,
                               rc < nk ? p.h + (rc / p.k) * p.h_le +
                                             (rc % p.k) * p.h_lc
                                       : nullptr,
                               i0, part + 2LL * D * w + (long long)rc * D, 1,
                               first);
            }
        }
        first = false;
    }
}

// out [D, 2w + k] from the G blocks' partial sums: a warp a trace value
// (its lanes over the blocks), or a composition column (its D^2 sums of
// coordinate products, then the extension's combination).
template <int D>
__global__ void __launch_bounds__(256)
ood_total_kernel(const u64* __restrict__ part, int G, int w, int k,
                 u64* __restrict__ out) {
    const int item = (blockIdx.x * 256 + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const long long V = 2LL * D * w + D * D * k;
    const int ld = 2 * w + k;
    if (item < 2 * D * w) {
        u64 s = 0;
        for (int b = lane; b < G; b += 32)
            s = f63_add(s, __ldg(part + b * V + item));
        s = warp_sum(s);
        const int v = item / w, j = item % w;
        if (lane == 0) out[(v % D) * ld + (v / D) * w + j] = s;
    } else if (item < 2 * D * w + k) {
        const int c = item - 2 * D * w;
        u64 r[2 * D - 1];
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) r[i] = 0;
#pragma unroll
        for (int e1 = 0; e1 < D; e1++)
#pragma unroll
            for (int e2 = 0; e2 < D; e2++) {
                const long long at = 2LL * D * w + (e1 * k + c) * D + e2;
                u64 s = 0;
                for (int b = lane; b < G; b += 32)
                    s = f63_add(s, __ldg(part + b * V + at));
                r[e1 + e2] = f63_add(r[e1 + e2], warp_sum(s));
            }
        u64 o[D];
        ext_combine<D>(r, o);
        if (lane == 0) {
#pragma unroll
            for (int e = 0; e < D; e++) out[e * ld + 2 * w + c] = o[e];
        }
    }
}

static int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

// The strips: as many a block, within one, as ceil(m / OOD_STRIP) over
// the resident blocks needs, of equal lengths L (a multiple of 32, at
// most OOD_STRIP), so the last wave is full.
template <int D>
static int ood_run(OodArgs p, const u64* pts, unsigned long long s,
                   u64* out, cudaStream_t st) {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ood_kernel<D>, OOD_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    cap = cap < p.rows ? cap : p.rows;
    const long long most = (p.m + 31) / 32, G0 = most < cap ? most : cap;
    const long long per = ((p.m + OOD_STRIP - 1) / OOD_STRIP + G0 - 1) / G0;
    p.L = (int)((p.m + per * G0 - 1) / (per * G0) + 31) / 32 * 32;
    p.strips = (p.m + p.L - 1) / p.L;
    const long long n = 3LL * p.L + 3 * p.strips;
    ood_pow_kernel<D><<<(int)((n + 255) / 256), 256, 0, st>>>(
        pts, s, p.strips, p.L, (u64*)p.tpow, (u64*)p.spow);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int G = (int)(p.strips < cap ? p.strips : cap);
    ood_kernel<D><<<G, OOD_THREADS, 0, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long items = 2LL * D * p.w + p.k;
    ood_total_kernel<D><<<(int)((items * 32 + 255) / 256), 256, 0, st>>>(
        p.part, G, p.w, p.k, out);
    return (int)cudaGetLastError();
}

// coef [w, m] (row stride c_ld), the composition coefficients h (element
// e h_le + c h_lc + i), the points pts [d, 3], the exponent s of index 0;
// scratch: rows (2 d w + d^2 k) + 3 d OOD_STRIP + 3 d ceil(m / 32)
// values, rows >= 1 the most blocks; out [d, 2 w + k]: the trace
// columns at z, then at z g, then the composition columns at z^k.
extern "C" int ood_launch(const void* coef, long long c_ld, int w,
                          const void* h, long long h_le, long long h_lc,
                          int k, const void* pts, long long s, long long m,
                          int d, void* scratch, long long rows, void* out,
                          void* stream) {
    if (m <= 0 || 2 * w + k <= 0) return 0;
    if (d < 1 || d > 3 || rows < 1) return (int)cudaErrorInvalidValue;
    const long long V = 2LL * d * w + (long long)d * d * k;
    u64* part = (u64*)scratch;
    u64* tpow = part + rows * V;
    u64* spow = tpow + 3LL * d * OOD_STRIP;
    // 16-byte loads where every row starts on 16 bytes
    const int al16 = ((unsigned long long)coef % 16 == 0 && c_ld % 2 == 0 &&
                      (unsigned long long)h % 16 == 0 && h_le % 2 == 0 &&
                      h_lc % 2 == 0);
    const OodArgs p = {(const u64*)coef, c_ld, w, (const u64*)h, h_le, h_lc,
                       k, m, 0, OOD_STRIP, tpow, spow, part, rows,
                       al16};
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned long long e0 = (unsigned long long)s;
    if (d == 1) return ood_run<1>(p, (const u64*)pts, e0, (u64*)out, st);
    if (d == 2) return ood_run<2>(p, (const u64*)pts, e0, (u64*)out, st);
    return ood_run<3>(p, (const u64*)pts, e0, (u64*)out, st);
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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
    int kc, kt;  // a group's chunks of 32 rows: composition, trace
    int nk;      // composition rows, D k
    int al16;    // every row 16-byte aligned
};

// Row r of chunk kappa: the composition row rc = 32 kappa + r (kappa <
// kc: coordinate rc / k of column rc mod k), else trace column 32 (kappa
// - kc) + r; null past the last.
__device__ __forceinline__ const u64* deep_row(const DeepArgs& p, int kappa,
                                               int r) {
    if (kappa < p.kc) {
        const int rc = 32 * kappa + r;
        return rc < p.nk ? p.h + (rc / p.k) * p.h_le + (rc % p.k) * p.h_lc
                         : nullptr;
    }
    const int j = 32 * (kappa - p.kc) + r;
    return j < p.w ? p.lde + j * p.lde_ld : nullptr;
}

// A point's DEEP value as u / nrm: the numerator n_z a + n_zg b + n_h c
// (n_p = sum_j g_j f_j(x) - sum_j g_j f_j(p), from the tensor cores) over
// the denominator den = (x - z)(x - z g)(x - z^k), with a = (x - z g)
// (x - z^k), b = (x - z)(x - z^k), c = (x - z)(x - z g). For D >= 2 the
// four are polynomials in the base-field x with the block's constant
// coefficients poly (2 + 5D multiplies), and u = num adj(den), nrm =
// norm(den); for D = 1, u = num and nrm = den.
template <int D>
__device__ __forceinline__ void deep_point(const u64 (&pz)[3][D],
                                           const u64 (&poly)[9][D],
                                           const u64 (&n)[3][D], u64 x,
                                           u64 (&u)[D], u64& nrm) {
    if constexpr (D == 1) {
        const u64 dz = msub(x, pz[0][0]), dzg = msub(x, pz[1][0]);
        const u64 dzk = msub(x, pz[2][0]);
        const u64 c = f63_mmul(dz, dzg);
        nrm = f63_mmul(c, dzk);
        Wide s;  // three products: no fold
        wide_zero(s);
        wide_mac(s, n[0][0], f63_mmul(dzg, dzk));
        wide_mac(s, n[1][0], f63_mmul(dz, dzk));
        wide_mac(s, n[2][0], c);
        u[0] = wide_redc(s);
    } else {
        const u64 x2 = f63_msqr(x), x3 = f63_mmul(x2, x);
        u64 a[D], b[D], c[D], den[D];
#pragma unroll
        for (int e = 0; e < D; e++) {
            a[e] = f63_add(f63_mmul(poly[0][e], x), poly[1][e]);
            b[e] = f63_add(f63_mmul(poly[2][e], x), poly[3][e]);
            c[e] = f63_add(f63_mmul(poly[4][e], x), poly[5][e]);
            den[e] = f63_add(f63_add(f63_mmul(poly[6][e], x2),
                                     f63_mmul(poly[7][e], x)),
                             poly[8][e]);
        }
        a[0] = f63_add(a[0], x2);
        b[0] = f63_add(b[0], x2);
        c[0] = f63_add(c[0], x2);
        den[0] = f63_add(den[0], x3);
        // 3 D products a sum: a fold after the first 2 D (<= FOLD_EVERY)
        Wide s[2 * D - 1];
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) wide_zero(s[i]);
        ext_mac<D>(s, n[0], a);
        ext_mac<D>(s, n[1], b);
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) wide_fold(s[i]);
        ext_mac<D>(s, n[2], c);
        u64 num[D], adj[D];
        ext_reduce<D>(s, num);
        nrm = ext_adj_norm<D>(den, adj);
        ext_mul<D>(num, adj, u);
    }
}

// Bytes of a block's dynamic shared memory: the ring, the B fragments,
// the row table, the kept sums and the run.
template <int D>
__host__ __device__ constexpr int deep_smem(int kc, int kt) {
    return DEEP_STAGES * DEEP_CHUNK +
           8 * 32 * (kc * (2 * D - 1) + kt * 2 * D) + 8 * 32 * (kc + kt) +
           8 * DEEP_THREADS * (4 * D - 1 + DeepRun<D>::R * (D + 2));
}

// The block's start: the row table (chunk kappa's 32 row pointers), the
// B fragments of the composition's 2D - 1 coefficient sums (n-tile e1 +
// e2) and of the trace's 2D sums (n-tile q D + e, q = z, z g) in shared
// memory; warp q < 3 sums cz[q] = sum_j g_q,j f_j(p_q), the OOD values
// weighted as the numerators are; the points and (D >= 2) the
// coefficients of a, b, c and den in x. Then the block's sub-rounds of
// 128 points (every G-th of the segment's), in rounds of up to R: a
// sub-round is four group steps of 32 points, warp w taking points 8w ..
// 8w + 7 of a step. A step's chunks (32 rows of its 32 points, 8 KB; a
// pad row copies a real one, its coefficients are 0) pass through the
// block's ring
// (cp.async, DEEP_STAGES chunks, DEEP_STAGES - 1 in flight, one barrier
// a chunk); each lane's 8 values of a chunk into A fragments and onto
// the tensor cores. After a step, quad_sums leaves each sum of a point
// in one lane of its quad, which keeps it (shared memory) for lane t =
// step: a sub-round leaves a lane one point, 32t + 8w + g, taken through
// deep_point into the run (u, nrm and the prefix product of the norms).
// Then one inversion a lane and back through the run.
template <int D>
__global__ void __launch_bounds__(DEEP_THREADS, 3)
deep_kernel(const __grid_constant__ DeepArgs p) {
    constexpr int R = DeepRun<D>::R, NT = 2 * D, NC = 2 * D - 1;
    constexpr int T = DEEP_THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ u64 cz[3][D], pz[3][D], poly[9][D];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3, CH = p.kc + p.kt;
    unsigned char* ring = smem;
    u64* bc = (u64*)(smem + DEEP_STAGES * DEEP_CHUNK);
    u64* bt = bc + p.kc * NC * 32;
    const u64** rowp = (const u64**)(bt + p.kt * NT * 32);  // [CH][32]
    u64* keep = (u64*)(rowp + CH * 32);  // [4D - 1][T]: the sums, trace
    u64* run = keep + (4 * D - 1) * T;   // then composition; [R][D + 2][T]:
    for (int i = tid; i < CH * 32; i += T) {  // u, nrm, prefix
        const u64* row = deep_row(p, i >> 5, i & 31);
        rowp[i] = row != nullptr ? row : i >> 5 < p.kc ? p.h : p.lde;
    }
    // lane (g, t) of k-step kappa, byte m: byte g of the coefficient of
    // the row 8t + (m + 2t) mod 8 of chunk kappa (where the A side reads
    // slot m); a composition row (e2, c) meets g_h,c coordinate e1 = v - e2
    for (int i = tid; i < p.kc * NC * 32; i += T) {
        const int ln = i & 31, v = (i >> 5) % NC, kappa = (i >> 5) / NC;
        u64 f = 0;
#pragma unroll
        for (int m = 0; m < 8; m++) {
            const int rc =
                32 * kappa + 8 * (ln & 3) + ((m + 2 * (ln & 3)) & 7);
            const int e1 = v - rc / p.k;
            const u64 x = rc < p.nk && e1 >= 0 && e1 < D
                              ? __ldg(p.gh + e1 * p.k + rc % p.k)
                              : 0;
            f |= (x >> (8 * (ln >> 2)) & 0xff) << (8 * m);
        }
        bc[i] = f;
    }
    for (int i = tid; i < p.kt * NT * 32; i += T) {
        const int ln = i & 31, v = (i >> 5) % NT, kappa = (i >> 5) / NT;
        const u64* gq = (v < D ? p.gz : p.gzg) + (v % D) * p.w;
        u64 f = 0;
#pragma unroll
        for (int m = 0; m < 8; m++) {
            const int j = 32 * kappa + 8 * (ln & 3) + ((m + 2 * (ln & 3)) & 7);
            const u64 x = j < p.w ? __ldg(gq + j) : 0;
            f |= (x >> (8 * (ln >> 2)) & 0xff) << (8 * m);
        }
        bt[i] = f;
    }
    if (warp < 3) {
        const int n = warp < 2 ? p.w : p.k;
        const u64* gq = warp == 0 ? p.gz : warp == 1 ? p.gzg : p.gh;
        const u64* o = warp == 0 ? p.oz : warp == 1 ? p.ozg : p.oh;
        Wide s[2 * D - 1];
#pragma unroll
        for (int i = 0; i < 2 * D - 1; i++) wide_zero(s[i]);
        for (int c = lane; c < n; c += 32) {
            u64 a[D], b[D];
#pragma unroll
            for (int e = 0; e < D; e++) {
                a[e] = __ldg(gq + e * n + c);
                b[e] = __ldg(o + e * n + c);
            }
            ext_mac<D>(s, a, b);
#pragma unroll
            for (int i = 0; i < 2 * D - 1; i++) wide_fold(s[i]);
        }
        u64 v[D];
        ext_reduce<D>(s, v);
#pragma unroll
        for (int e = 0; e < D; e++) {
            const u64 x = warp_sum(v[e]);
            if (lane == 0) cz[warp][e] = x;
        }
    } else if (lane == 0) {
        u64 z[3][D];
#pragma unroll
        for (int q = 0; q < 3; q++)
#pragma unroll
            for (int e = 0; e < D; e++)
                pz[q][e] = z[q][e] = __ldg(p.pts + e * 3 + q);
        if constexpr (D >= 2) {
            // (x - z g)(x - z^k) = x^2 + A1 x + A0 (poly 0, 1), the same
            // for b (2, 3) and c (4, 5); den = x^3 + D2 x^2 + D1 x + D0
            // (6, 7, 8)
            u64 a0[D], b0[D], c0[D], zzz[D];
            ext_mul<D>(z[1], z[2], a0);
            ext_mul<D>(z[0], z[2], b0);
            ext_mul<D>(z[0], z[1], c0);
            ext_mul<D>(c0, z[2], zzz);
#pragma unroll
            for (int e = 0; e < D; e++) {
                poly[0][e] = msub(0, f63_add(z[1][e], z[2][e]));
                poly[1][e] = a0[e];
                poly[2][e] = msub(0, f63_add(z[0][e], z[2][e]));
                poly[3][e] = b0[e];
                poly[4][e] = msub(0, f63_add(z[0][e], z[1][e]));
                poly[5][e] = c0[e];
                poly[6][e] = msub(0, f63_add(f63_add(z[0][e], z[1][e]),
                                             z[2][e]));
                poly[7][e] = f63_add(f63_add(a0[e], b0[e]), c0[e]);
                poly[8][e] = msub(0, zzz[e]);
            }
        }
    }
    __syncthreads();

    // the block's sub-rounds: blockIdx.x + i G of the segment's (i <
    // mine), so the grid's blocks read neighbouring points at a time and
    // none takes more than one sub-round more than another; in rounds of
    // R (the last one shorter)
    const long long subs = (p.S + 127) / 128, G = gridDim.x;
    const long long mine =
        blockIdx.x < subs ? (subs - 1 - blockIdx.x) / G + 1 : 0;
    const long long total = mine * 4 * CH;  // the block's chunks
    long long issued = 0, used = 0;
    // the next chunk to issue: kappa ik of step istep (points ix0 ..
    // ix0 + 31) of the block's sub-round isub
    int ik = 0, istep = 0;
    long long isub = 0, ix0 = 128LL * blockIdx.x;
    // chunk `issued` into its stage: 512 copies of 16 bytes (2 points;
    // else 8 bytes a point), four a thread; points at or past S are not
    // copied (a point past S is never written)
    auto issue = [&]() {
        if (issued < total) {
            unsigned char* stage = ring + (issued % DEEP_STAGES) * DEEP_CHUNK;
            if (p.al16 && ix0 + 32 <= p.S) {
#pragma unroll
                for (int i = 0; i < 4; i++) {
                    const int piece = tid + T * i, r = piece >> 4;
                    const int q = piece & 15;
                    cp_async16(stage + r * DEEP_ROW + 16 * q,
                               rowp[ik * 32 + r] + ix0 + 2 * q, 16);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 4; i++) {
                    const int piece = tid + T * i, r = piece >> 4;
                    const int q = piece & 15;
                    const u64* row = rowp[ik * 32 + r];
                    const long long x = ix0 + 2 * q;
                    if (x >= p.S) continue;
                    unsigned char* dst = stage + r * DEEP_ROW + 16 * q;
                    if (p.al16) {
                        cp_async16(dst, row + x, x + 1 < p.S ? 16 : 8);
                    } else {
                        cp_async8(dst, row + x);
                        if (x + 1 < p.S) cp_async8(dst + 8, row + x + 1);
                    }
                }
            }
            if (++ik == CH) {
                ik = 0;
                ix0 += 32;
                if (++istep == 4) {
                    istep = 0;
                    ix0 = 128 * (blockIdx.x + ++isub * G);
                }
            }
        }
        cp_async_commit();
        issued++;
    };
    // the next chunk's values of this lane's point 8w + g at its K slots
    // m: rows 8t + (m + 2t) mod 8. After the barrier every thread is done
    // with the stage read last, which takes the chunk DEEP_STAGES - 1
    // ahead.
    auto take = [&](u64 (&v)[8]) {
        cp_async_wait<DEEP_STAGES - 2>();
        __syncthreads();
        issue();
        const unsigned char* st = ring + (used % DEEP_STAGES) * DEEP_CHUNK +
                                  8 * (8 * warp + g);
#pragma unroll
        for (int m = 0; m < 8; m++)
            v[m] = *(const u64*)(st + (8 * t + ((m + 2 * t) & 7)) * DEEP_ROW);
        used++;
    };
#pragma unroll 1
    for (int i = 0; i < DEEP_STAGES - 1; i++) issue();

#pragma unroll 1
    for (long long i0 = 0; i0 < mine; i0 += R) {
        const int rl = mine - i0 < R ? (int)(mine - i0) : R;  // the run
        unsigned zero = 0;
#pragma unroll 1
        for (int r = 0; r < rl; r++) {
            const long long base = 128 * (blockIdx.x + (i0 + r) * G);
#pragma unroll 1
            for (int gam = 0; gam < 4; gam++) {
                int acc2[4][NC][4];
#pragma unroll
                for (int u = 0; u < 4; u++)
#pragma unroll
                    for (int n = 0; n < NC; n++)
#pragma unroll
                        for (int c = 0; c < 4; c++) acc2[u][n][c] = 0;
#pragma unroll 1
                for (int kappa = 0; kappa < p.kc; kappa++) {
                    u64 v[8];
                    u32 A[4][4];
                    take(v);
                    a_frags(v, A);
#pragma unroll
                    for (int n = 0; n < NC; n++) {
                        const u64 b = bc[(kappa * NC + n) * 32 + lane];
#pragma unroll
                        for (int u = 0; u < 4; u++)
                            mma_u8(acc2[u][n], A[u], b);
                    }
                }
                // sum 4j + t of this lane's point, kept for lane (g, gam)
                const int keeper = 32 * warp + 4 * g + gam;
                {
                    u64 sc[(NC + 3) / 4];
                    quad_sums<NC>(acc2, sc);
#pragma unroll
                    for (int i = 0; i < (NC + 3) / 4; i++)
                        if (4 * i + t < NC)
                            keep[(NT + 4 * i + t) * T + keeper] = sc[i];
                }
                int acc[4][NT][4];
#pragma unroll
                for (int u = 0; u < 4; u++)
#pragma unroll
                    for (int n = 0; n < NT; n++)
#pragma unroll
                        for (int c = 0; c < 4; c++) acc[u][n][c] = 0;
#pragma unroll 1
                for (int kappa = 0; kappa < p.kt; kappa++) {
                    u64 v[8];
                    u32 A[4][4];
                    take(v);
                    a_frags(v, A);
#pragma unroll
                    for (int n = 0; n < NT; n++) {
                        const u64 b = bt[(kappa * NT + n) * 32 + lane];
#pragma unroll
                        for (int u = 0; u < 4; u++) mma_u8(acc[u][n], A[u], b);
                    }
                }
                u64 st[(NT + 3) / 4];
                quad_sums<NT>(acc, st);
#pragma unroll
                for (int i = 0; i < (NT + 3) / 4; i++)
                    if (4 * i + t < NT) keep[(4 * i + t) * T + keeper] = st[i];
            }
            __syncwarp();
            const long long j = base + 32 * t + 8 * warp + g;
            u64 nn[3][D], sc[2 * D - 1], u[D], nrm = F63_ONE;
#pragma unroll
            for (int q = 0; q < 2; q++)
#pragma unroll
                for (int e = 0; e < D; e++)
                    nn[q][e] = msub(keep[(q * D + e) * T + tid], cz[q][e]);
#pragma unroll
            for (int n = 0; n < 2 * D - 1; n++)
                sc[n] = keep[(NT + n) * T + tid];
            ext_combine<D>(sc, nn[2]);
#pragma unroll
            for (int e = 0; e < D; e++) nn[2][e] = msub(nn[2][e], cz[2][e]);
#pragma unroll
            for (int e = 0; e < D; e++) u[e] = 0;
            if (j < p.S) deep_point<D>(pz, poly, nn, __ldg(p.xs + j), u, nrm);
            if (nrm == 0) {
                zero |= 1u << r;
                nrm = F63_ONE;
            }
            u64* slot = run + r * (D + 2) * T + tid;
#pragma unroll
            for (int e = 0; e < D; e++) slot[e * T] = u[e];
            slot[D * T] = nrm;
            // the prefix product: slot[-T] is sub-round r - 1's
            slot[(D + 1) * T] = r == 0 ? nrm : f63_mmul(slot[-T], nrm);
        }
        // 1 / (nrm_0 ... nrm_r) as r falls
        u64 inv = inv_base(run[((rl - 1) * (D + 2) + D + 1) * T + tid]);
#pragma unroll 1
        for (int r = rl - 1; r >= 0; r--) {
            const u64* slot = run + r * (D + 2) * T + tid;
            u64 id = inv;
            if (r > 0) {
                id = f63_mmul(inv, slot[-T]);  // the prefix to r - 1
                inv = f63_mmul(inv, slot[D * T]);
            }
            const long long j =
                128 * (blockIdx.x + (i0 + r) * G) + 32 * t + 8 * warp + g;
            if (j < p.S) {
#pragma unroll
                for (int e = 0; e < D; e++)
                    p.out[e * p.out_ld + j] =
                        zero >> r & 1 ? 0 : f63_mmul(slot[e * T], id);
            }
        }
    }
    cp_async_wait<0>();
}

template <int D>
static int deep_run(const DeepArgs& p, cudaStream_t st) {
    constexpr int R = DeepRun<D>::R;
    const int smem = deep_smem<D>(p.kc, p.kt);
    static int smem_set = 0;  // the largest dynamic size allowed so far
    cudaError_t e;
    if (smem > smem_set) {
        e = cudaFuncSetAttribute(deep_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deep_kernel<D>,
                                                      DEEP_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    const long long subs = (p.S + 127) / 128;
    const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    deep_kernel<D><<<(int)(subs < cap ? subs : cap), DEEP_THREADS, smem,
                     st>>>(p);
    return (int)cudaGetLastError();
}

// The trace segment lde [w, S] (row stride lde_ld), the composition
// segment h (element e h_le + c h_lc + j), the domain points xs [S], the
// points pts [d, 3], the OOD values oz, ozg [d, w] and oh [d, k], the
// coefficients g_z, g_zg [d, w] and g_h [d, k]; out [d, S] with row
// stride out_ld. w <= DEEP_MAX_W, k <= DEEP_MAX_K.
extern "C" int deep_launch(const void* lde, long long lde_ld, const void* h,
                           long long h_le, long long h_lc, const void* xs,
                           const void* pts, const void* oz, const void* ozg,
                           const void* oh, const void* gz, const void* gzg,
                           const void* gh, int w, int k, int d, long long S,
                           void* out, long long out_ld, void* stream) {
    if (S <= 0) return 0;
    if (d < 1 || d > 3 || w < 1 || w > DEEP_MAX_W || k < 1 || k > DEEP_MAX_K)
        return (int)cudaErrorInvalidValue;
    const int al16 = ((unsigned long long)lde % 16 == 0 && lde_ld % 2 == 0 &&
                      (unsigned long long)h % 16 == 0 && h_le % 2 == 0 &&
                      h_lc % 2 == 0);
    const DeepArgs p = {(const u64*)lde, lde_ld, (const u64*)h, h_le, h_lc,
                        (const u64*)xs, (const u64*)pts, (const u64*)oz,
                        (const u64*)ozg, (const u64*)oh, (const u64*)gz,
                        (const u64*)gzg, (const u64*)gh, w, k, S, (u64*)out,
                        out_ld, (d * k + 31) / 32, (w + 31) / 32, d * k,
                        al16};
    const cudaStream_t st = (cudaStream_t)stream;
    if (d == 1) return deep_run<1>(p, st);
    if (d == 2) return deep_run<2>(p, st);
    return deep_run<3>(p, st);
}

// ---- fri_fold --------------------------------------------------------------
// One FRI layer's fold. Point j's FOLD values v_t sit at x w^(t step) (w^step
// = -1 for FOLD 2, the fourth root i for FOLD 4); with 1/x from the split
// table, the fold is
//   FOLD 2: o = [(v0 + v1) + xi (v0 - v1) / x] / 2,
//   FOLD 4: A = (v0 + v2) + xi (v0 - v2) / x,
//           B = (v1 + v3) + xi (v1 - v3) / (x w^step),
//           o = [(A + B) + xi^2 (A - B) / x^2] / 4:
// engine/fri.py's radix-2 folds (a + b) / 2 + xi (a - b) / (2x), the second
// with xi^2 at x^2, with their halvings merged into one 1/FOLD. A point
// costs 2 d + 1 Montgomery multiplies and one extension multiply at FOLD 2,
// 4 d + 3 and three at FOLD 4 (radix-2 folds in turn take 2 d + 2 and
// 6 d + 6 with four). xi and xi^2 are worked out once a layer on the host
// and come by value; a thread builds their multiplication matrices once
// (additions only), so that a product by either is d sums of d products,
// each reduced once (ext_mul's 2 d - 1 reductions and its combination by
// x^d fall away). A thread takes one point a round (8-byte loads and
// stores), over a grid of at most the resident blocks: at d = 3, 48
// registers leave 5 blocks of 256 threads an SM resident. Two adjacent
// points a thread with 16-byte loads took 74 registers (3 blocks) at
// d = 3, fold 4 and ran 5-12% slower there, alike at d = 1 (PERF.md).
//
// The output: coordinate e of point j at out[(r D + e) m + c], r = j >>
// m_log, c = j mod 2^m_log. With m = L and m_log = 63 that is [D, L]; with
// m = L / f = 2^m_log it is the next layer's leaf rows [f, D, L / f]
// (engine/fri.py leaf_rows of the [D, L] values, folding f), which that
// layer commits and folds from without a copy.
struct FoldArgs {
    const u64* src;  // value t, coordinate e of point j: src[t ld_t + e ld_e
    long long ld_t, ld_e;  // + j]
    long long L, j0;  // points; the first one's position in the layer
    const u64 *lo, *hi;  // (o w^e)^-1 = lo[e mod 2^h] hi[e >> h]
    int h;
    int m_log;       // the output's row: point j in row j >> m_log
    long long m;     // the output's row length
    u64 step_inv;    // w^-step: 1/x at position e + step from 1/x at e
    u64 scale;       // 1 / FOLD
    u64 xi[3], xi2[3];  // the folding scalar and its square, by value
    u64* out;
};

// The multiplication matrix of a (D x D, row-major): column i holds the
// coordinates of a x^i, so that (a t)_e = sum_i m[e D + i] t_i; x^2 = 3,
// or x^3 = 3 x + 1 (ext_combine).
template <int D>
__device__ __forceinline__ void ext_matrix(const u64* a, u64 (&m)[D * D]) {
    if constexpr (D == 1) {
        m[0] = a[0];
    } else if constexpr (D == 2) {
        m[0] = a[0];
        m[1] = mtriple(a[1]);
        m[2] = a[1];
        m[3] = a[0];
    } else {
        const u64 b1 = f63_add(a[0], mtriple(a[2]));  // a x = (a2, b1, a1)
        m[0] = a[0], m[1] = a[2], m[2] = a[1];
        m[3] = a[1], m[4] = b1, m[5] = f63_add(a[2], mtriple(a[1]));
        m[6] = a[2], m[7] = a[1], m[8] = b1;
    }
}

// c = a t for the constant a given as its matrix m; c may be t.
template <int D>
__device__ __forceinline__ void ext_mul_mat(const u64 (&t)[D],
                                            const u64 (&m)[D * D],
                                            u64 (&c)[D]) {
    if constexpr (D == 1) {
        c[0] = f63_mmul(t[0], m[0]);
    } else {
        u64 r[D];
#pragma unroll
        for (int e = 0; e < D; e++) {
            Wide s;  // D <= FOLD_EVERY products: no fold
            wide_zero(s);
#pragma unroll
            for (int i = 0; i < D; i++) wide_mac(s, t[i], m[e * D + i]);
            r[e] = wide_redc(s);
        }
#pragma unroll
        for (int e = 0; e < D; e++) c[e] = r[e];
    }
}

template <int D, int FOLD>
__device__ __forceinline__ void fold_point(const u64 (&v)[FOLD][D], u64 ix,
                                           const FoldArgs& p,
                                           const u64 (&m1)[D * D],
                                           const u64 (&m2)[D * D],
                                           u64 (&o)[D]) {
    u64 t[D];
#pragma unroll
    for (int e = 0; e < D; e++)
        t[e] = f63_mmul(msub(v[0][e], v[FOLD / 2][e]), ix);
    ext_mul_mat<D>(t, m1, t);
    if constexpr (FOLD == 2) {
#pragma unroll
        for (int e = 0; e < D; e++)
            o[e] = f63_mmul(f63_add(f63_add(v[0][e], v[1][e]), t[e]),
                            p.scale);
    } else {
        u64 a[D], b[D];
#pragma unroll
        for (int e = 0; e < D; e++)
            a[e] = f63_add(f63_add(v[0][e], v[2][e]), t[e]);
        const u64 ix1 = f63_mmul(ix, p.step_inv);  // 1 / (x w^step)
#pragma unroll
        for (int e = 0; e < D; e++)
            t[e] = f63_mmul(msub(v[1][e], v[3][e]), ix1);
        ext_mul_mat<D>(t, m1, t);
#pragma unroll
        for (int e = 0; e < D; e++)
            b[e] = f63_add(f63_add(v[1][e], v[3][e]), t[e]);
        const u64 ix2 = f63_msqr(ix);  // 1 / x^2
#pragma unroll
        for (int e = 0; e < D; e++) t[e] = f63_mmul(msub(a[e], b[e]), ix2);
        ext_mul_mat<D>(t, m2, t);
#pragma unroll
        for (int e = 0; e < D; e++)
            o[e] = f63_mmul(f63_add(f63_add(a[e], b[e]), t[e]), p.scale);
    }
}

template <int D, int FOLD>
__global__ void __launch_bounds__(FOLD_THREADS)
fri_fold_kernel(const __grid_constant__ FoldArgs p) {
    const unsigned long long tmask = (1ull << p.h) - 1,
                             cmask = (1ull << p.m_log) - 1;
    u64 m1[D * D], m2[D * D];
    ext_matrix<D>(p.xi, m1);
    ext_matrix<D>(p.xi2, m2);
    for (long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
         j < p.L; j += (long long)gridDim.x * FOLD_THREADS) {
        u64 v[FOLD][D];
#pragma unroll
        for (int t = 0; t < FOLD; t++)
#pragma unroll
            for (int e = 0; e < D; e++)
                v[t][e] = __ldg(p.src + t * p.ld_t + e * p.ld_e + j);
        const unsigned long long pos = (unsigned long long)(p.j0 + j);
        const u64 ix = f63_mmul(__ldg(p.lo + (pos & tmask)),
                                __ldg(p.hi + (pos >> p.h)));  // 1 / x
        u64 o[D];
        fold_point<D, FOLD>(v, ix, p, m1, m2, o);
        u64* dst = p.out + (long long)(((unsigned long long)j >> p.m_log) *
                                       D) * p.m +
                   (long long)((unsigned long long)j & cmask);
#pragma unroll
        for (int e = 0; e < D; e++) dst[e * p.m] = o[e];
    }
}

template <int D, int FOLD>
static int fold_run(const FoldArgs& p, cudaStream_t st) {
    static long long cap = 0;  // the resident blocks, once a process
    if (cap == 0) {
        int per_sm = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fri_fold_kernel<D, FOLD>, FOLD_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    }
    const long long need = (p.L + FOLD_THREADS - 1) / FOLD_THREADS;
    fri_fold_kernel<D, FOLD>
        <<<(int)(need < cap ? need : cap), FOLD_THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
}

template <int D>
static int fold_pick(const FoldArgs& p, int fold, cudaStream_t st) {
    if (fold == 2) return fold_run<D, 2>(p, st);
    if (fold == 4) return fold_run<D, 4>(p, st);
    return (int)cudaErrorInvalidValue;
}

// src: value t, coordinate e of point j at src[t ld_t + e ld_e + j] (t <
// fold, e < d, j < L); the points' positions j0 + j + t step in the
// layer, whose 1/x is lo[e mod 2^h] hi[e >> h]; step_inv = w^-step and
// scale = 1/fold Montgomery; xi, xi2: the folding scalar and its square,
// d Montgomery coordinates each (host memory, passed to the kernel by
// value); out: point j, coordinate e at out[((j >> m_log) d + e) m +
// (j mod 2^m_log)] (m = L, m_log = 63: [d, L]).
extern "C" int fri_fold_launch(const void* src, long long ld_t,
                               long long ld_e, long long L, long long j0,
                               const void* lo, const void* hi, int h,
                               long long step_inv, long long scale,
                               const unsigned long long* xi,
                               const unsigned long long* xi2, int d,
                               int fold, void* out, long long m, int m_log,
                               void* stream) {
    if (L <= 0) return 0;
    if (d < 1 || d > 3 || m_log < 0 || m_log > 63)
        return (int)cudaErrorInvalidValue;
    FoldArgs p = {(const u64*)src, ld_t, ld_e, L, j0, (const u64*)lo,
                  (const u64*)hi, h, m_log, m, (u64)step_inv, (u64)scale,
                  {}, {}, (u64*)out};
    for (int e = 0; e < d; e++) {
        p.xi[e] = xi[e];
        p.xi2[e] = xi2[e];
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (d == 1) return fold_pick<1>(p, fold, st);
    if (d == 2) return fold_pick<2>(p, fold, st);
    return fold_pick<3>(p, fold, st);
}
