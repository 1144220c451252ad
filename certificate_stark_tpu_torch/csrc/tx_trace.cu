// The composed state-transition AIR's trace: T transaction windows of 1024
// rows over 94 columns, written as the Montgomery trace [94, T*1024].
//
// Replaces certificate_stark_tpu/models/trace_device.py `build_trace_device`
// (:36-119 and the column lanes of `_jit_window`, :215-322: lax.scan lanes
// in XLA). The point formulas are native/air_eval.c's (`ec_double` :134,
// `ec_add_mixed` :163, `ec_add` :196), the fp6 inverse ops/ecc.py's
// `f6_inv`, on f63.cuh's word-level Montgomery arithmetic. The plain
// version is models/trace_device.py `build_trace_plain`.
//
// Bound on the H100: one transaction is a few chains of dependent
// Montgomery multiplies (the Rescue rounds of four Merkle clusters, 16 tree
// levels x 7 rounds; the 5-cycle message-hash sponge; 255 double-and-add
// pairs of two fp6 scalar multiplications; the final fp6 inverse) and it
// writes 752 KB. At 128 transactions the card's multiply rate and memory
// are far from the limit: the kernel is bound by the latency and issue
// rate of those chains. What the design does:
// - one block per transaction, its 1024-row window split into the column
//   lanes of the JAX package, which never write each other's columns, so
//   they run side by side on four warps, one an SM sub-partition:
//     warps 0-1  the EC lane, one warp a point: s.G on cols 0..18, h.P on
//                cols 19..37, rows 512..1023. A point's fp6 arithmetic is
//                spread over its warp: one multiply on 6 lanes as 6 dot
//                products of 6 unreduced products, one reduction each, and
//                up to 5 multiplies of a point formula at once (see "fp6
//                arithmetic spread over a warp"). At row 1023 the two warps
//                meet at a barrier for the final addition and the fp6
//                inverse;
//     warps 2-3  the Merkle lane, cols 0..57 rows 0..511: the clusters
//                S_INIT 0, S_UPD 15 (warp 2), R_INIT 29, R_UPD 44 (warp 3)
//                on 16-thread groups (rescue_perm.cu's layout: a thread
//                holds one lane and its MDS row, an MDS layer gathers the
//                group with shuffles; the sibling injection is a per-lane
//                select); the bit registers 14 and 43 on lane 14 of the
//                S_INIT and R_INIT groups. Then warp 2 runs the hash lane,
//                cols 42..55 rows 512..1023 (5 sponge cycles of 7 rounds on
//                one 16-thread group, the message injected), with the
//                h-limb accumulator 38..41 and the range lanes 56/57, 92/93
//                on lanes 16..23, one column a lane; warp 3 writes the
//                columns that are constant or copies: PREV_ROOT 58..64
//                (init rows, then the R_UPD digest from row thl), 65..91,
//                and 92/93 on rows 0..511;
// - stores by row tiles: each lane puts its columns' values for 32 rows in
//   shared memory, then its warp writes each column's 32 rows with
//   consecutive threads on consecutive rows (one 256-byte store a column;
//   the rows of a column are contiguous within a transaction's window).
#include <cuda_runtime.h>

#include "f63.cuh"

#define WIDTH 94
#define CYCLE 1024
#define HALF 512
#define TILE 32             // rows a warp buffers before it stores them
#define PAD 33              // row stride of a shared tile, in u64
#define GROUP 16            // threads of one Rescue state
#define THREADS 128         // 4 warps, one an SM sub-partition: s.G, h.P,
                            // Merkle + hash/range, Merkle + copies
#define FULL 0xffffffffu

__device__ __forceinline__ u64 mdbl(u64 a) { return f63_add(a, a); }
__device__ __forceinline__ u64 bit_m(u64 b) { return b ? F63_ONE : 0; }

// ---- fp6 arithmetic spread over a warp (ops/ecc.py f6_mul) ----------------
// fp2 = fp[u]/(u^2 - 2u - 2), fp6 = fp2[v]/(v^3 + v + 1); an fp6 value is
// (a0 + a1 u) + (a2 + a3 u) v + (a4 + a5 u) v^2, six coordinates on the
// basis e_i = u^(i & 1) v^(i >> 1). A product a * b is sum_i a_i (b e_i):
// coordinate k of it is the dot product of a with column k of the matrix
// whose row i is b e_i. So a multiply takes two steps, each on one lane a
// row or a coordinate: 6 lanes build the rows of b's matrix (b e_i from b
// by the linear maps x u and x v, additions only), then 6 lanes each sum
// 6 unreduced 128-bit products a_i w[i][k] (< 6 p^2 < 2^128) and reduce
// once. The multiplies of one step of a point formula that do not depend on
// each other run together, up to 5 (30 lanes). Values live in shared
// memory between the steps; every lane of the warp runs the same code.
// tests/test_torch_trace_lanes.py models the split in Python ints.

#define NV 32               // fp6 slots of a point warp
#define NW 9                // multiplication matrices of a point warp
// matrices: the curve constant b3's (sparse, see prods); the fixed point's
// x, y and x + y; D0..D4 for one step's multiplies
enum { W_B3, W_QX, W_QY, W_QXY, D0, D1, D2, D3, D4 };
// fixed slots: the running point, the fixed point, b3, and h.P at the end;
// then the temporaries of one formula, reused by the next
enum { X, Y, Z, QX, QY, B3S, HX, HY, HZ, S9, S10 };

struct EcShared {
    u64 v[NV][6];           // fp6 values by slot
    u64 w[NW][6][6];        // w[m][i][k] = coordinate k of b e_i
};

// Up to 6 slot or matrix numbers of a step, 5 bits each.
__host__ __device__ constexpr u32 pk(int a, int b = 0, int c = 0, int d = 0,
                                     int e = 0, int f = 0) {
    return a | b << 5 | c << 10 | d << 15 | e << 20 | (u32)f << 25;
}
__device__ __forceinline__ int fld(u32 x, int j) { return x >> (5 * j) & 31; }

// x u on each fp2 coordinate pair: (x0, x1) -> (2 x1, x0 + 2 x1).
__device__ __forceinline__ void mul_u(u64 x[6]) {
#pragma unroll
    for (int q = 0; q < 3; q++) {
        const u64 d = mdbl(x[2 * q + 1]);
        x[2 * q + 1] = f63_add(x[2 * q], d);
        x[2 * q] = d;
    }
}

// x v: (X0, X1, X2) -> (-X2, X0 - X2, X1) on fp2 coordinates.
__device__ __forceinline__ void mul_v(u64 x[6]) {
    const u64 x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    x[0] = msub(0, x[4]);
    x[1] = msub(0, x[5]);
    x[2] = msub(x0, x[4]);
    x[3] = msub(x1, x[5]);
    x[4] = x2;
    x[5] = x3;
}

// The two steps of a multiply are functions of their own, not inlined: with
// every call inlined the kernel had 10,920 SASS instructions, not 6,732,
// and took 1.49 ms for 128 transactions on an H100, not 1.09 ms, though
// 0.92 ms, not 1.04, for one; the larger code likely misses in the
// instruction caches once every SM runs it.

// Step 1 of nw multiplies: lane 6j + i writes row i of the matrix of slot
// fld(srcs, j) into matrix fld(dsts, j).
__device__ __noinline__ void wrows(EcShared& e, int lane, int nw, u32 srcs,
                                      u32 dsts) {
    if (lane < 6 * nw) {
        const int j = lane / 6, i = lane % 6;
        const u64* b = e.v[fld(srcs, j)];
        u64 x[6];
#pragma unroll
        for (int c = 0; c < 6; c++) x[c] = b[c];
        if (i >= 2) mul_v(x);
        if (i >= 4) mul_v(x);
        if (i & 1) mul_u(x);
        u64* row = e.w[fld(dsts, j)][i];
#pragma unroll
        for (int c = 0; c < 6; c++) row[c] = x[c];
    }
    __syncwarp();
}

// (c3 c2 c1 c0) += (d3 d2 d1 d0); the caller keeps the sum below 2^128.
__device__ __forceinline__ void add128(u32 c[4], const u32 d[4]) {
    const u64 lo = join32(c[0], c[1]) + join32(d[0], d[1]);
    const u64 hi = join32(c[2], c[3]) + join32(d[2], d[3]) +
                   (lo < join32(d[0], d[1]));
    c[0] = lo32(lo); c[1] = hi32(lo); c[2] = lo32(hi); c[3] = hi32(hi);
}

// Step 2 of nm multiplies: lanes 6f + k write coordinate k of slot
// fld(ds, f) = slot fld(as, f) times the value of matrix fld(ws, f): 6
// products summed unreduced in two carry chains of 3, then added and
// reduced once. A multiply by b3 (bit f of b3mask) keeps its sparsity: b3
// e_i lies in e_i's fp2 pair for an fp2 b3 (form 1), on e_i itself for a
// base-subfield b3 (form 0), so coordinate k sums 2 products or 1, not 6.
// No step writes a slot it reads.
__device__ __noinline__ void prods(EcShared& e, int lane, int nm, u32 as,
                                      u32 ws, u32 ds, u32 b3mask,
                                      int b3form) {
    for (int o = lane; o < 6 * nm; o += 32) {
        const int f = o / 6, k = o % 6;
        const int form = b3mask >> f & 1 ? b3form : 2;
        const u64* a = e.v[fld(as, f)];
        u64(*w)[6] = e.w[fld(ws, f)];
        u32 c[4];
        if (form == 2) {
            u64 av[6], wv[6];
#pragma unroll
            for (int i = 0; i < 6; i++) {
                av[i] = a[i];
                wv[i] = w[i][k];
            }
            u32 d[4];
            f63_mul_wide(av[0], wv[0], c[0], c[1], c[2], c[3]);
            f63_mul_wide(av[1], wv[1], d[0], d[1], d[2], d[3]);
            f63_mac(c, av[2], wv[2]);
            f63_mac(d, av[3], wv[3]);
            f63_mac(c, av[4], wv[4]);
            f63_mac(d, av[5], wv[5]);
            add128(c, d);
        } else {
            const int i = form == 1 ? k & ~1 : k;
            f63_mul_wide(a[i], w[i][k], c[0], c[1], c[2], c[3]);
            if (form == 1) f63_mac(c, a[i + 1], w[i + 1][k]);
        }
        e.v[fld(ds, f)][k] = f63_redc_wide(c);
    }
    __syncwarp();
}

// ---- point ops on projective [X||Y||Z] (ops/ecc.py compute_*) ------------
// The formulas of native/air_eval.c `ec_double` (:134), `ec_add_mixed`
// (:163) and `ec_add` (:196), their multiplies grouped by dependence into
// three steps; lanes 0..5 do the additions between steps, coordinate k on
// lane k. The point is slots X, Y, Z; the result goes back there.

__device__ __forceinline__ void ec_double(EcShared& e, int lane,
                                         int b3form) {
    enum { T0 = S9, T1, T2, T3, Z3, Y3, ZB, S, X3, T0N, T3N, Y3N, X3N, T0A,
           T0B, Z3N };
    u64(*v)[6] = e.v;
    const int k = lane;
    // x^2, y^2, z^2, x y, x z
    wrows(e, lane, 3, pk(X, Y, Z), pk(D0, D1, D2));
    prods(e, lane, 5, pk(X, Y, Z, X, X), pk(D0, D1, D2, D1, D2),
          pk(T0, T1, T2, T3, Z3), 0, b3form);
    if (lane < 6) {
        v[T3][k] = mdbl(v[T3][k]);
        v[Z3][k] = mdbl(v[Z3][k]);
    }
    __syncwarp();
    // b3 z^2, b3 2xz, y z
    prods(e, lane, 3, pk(T2, Z3, Y), pk(W_B3, W_B3, D2), pk(Y3, ZB, S), 3,
          b3form);
    if (lane < 6) {
        const u64 t0 = v[T0][k], t1 = v[T1][k], t2 = v[T2][k];
        const u64 y3 = f63_add(v[Z3][k], v[Y3][k]);
        v[X3][k] = msub(t1, y3);
        v[Y3][k] = f63_add(t1, y3);
        v[T3N][k] = f63_add(msub(t0, t2), v[ZB][k]);
        v[T0N][k] = f63_add(f63_add(mdbl(t0), t0), t2);
        v[S][k] = mdbl(v[S][k]);
    }
    __syncwarp();
    wrows(e, lane, 3, pk(X3, T3N, T1), pk(D0, D1, D2));
    prods(e, lane, 5, pk(Y3, T3, T0N, S, S), pk(D0, D0, D1, D1, D2),
          pk(Y3N, X3N, T0A, T0B, Z3N), 0, b3form);
    if (lane < 6) {
        v[X][k] = msub(v[X3N][k], v[T0B][k]);
        v[Y][k] = f63_add(v[Y3N][k], v[T0A][k]);
        v[Z][k] = mdbl(mdbl(v[Z3N][k]));
    }
    __syncwarp();
}

// P + Q with Q = (QX, QY, 1), whose matrices W_QX, W_QY, W_QXY are built
// once.
__device__ __forceinline__ void ec_add_mixed(EcShared& e, int lane,
                                            int b3form) {
    enum { SXY = S9, T0, T1, T3, T4, X3, Z3, T1N, T2, Y3, T4B, T5, T4N, T0A,
           T0B, A1, T0C, A2 };
    u64(*v)[6] = e.v;
    const int k = lane;
    if (lane < 6) v[SXY][k] = f63_add(v[X][k], v[Y][k]);
    __syncwarp();
    prods(e, lane, 5, pk(X, Y, SXY, Z, Z), pk(W_QX, W_QY, W_QXY, W_QX, W_B3),
          pk(T0, T1, T3, T4, X3), 1 << 4, b3form);
    if (lane < 6) {
        const u64 t0 = v[T0][k], t1 = v[T1][k], z1 = v[Z][k];
        v[T3][k] = msub(v[T3][k], f63_add(t0, t1));
        const u64 t4 = f63_add(v[T4][k], v[X][k]);
        v[T4][k] = t4;
        const u64 z3 = f63_add(v[X3][k], t4);
        v[X3][k] = msub(t1, z3);
        v[Z3][k] = f63_add(t1, z3);
        v[T1N][k] = f63_add(f63_add(mdbl(t0), t0), z1);
        v[T2][k] = msub(t0, z1);
    }
    __syncwarp();
    wrows(e, lane, 1, pk(Z3), pk(D0));
    prods(e, lane, 3, pk(X3, T4, Z), pk(D0, W_B3, W_QY), pk(Y3, T4B, T5),
          1 << 1, b3form);
    if (lane < 6) {
        v[T4N][k] = f63_add(v[T4B][k], v[T2][k]);
        v[T5][k] = f63_add(v[T5][k], v[Y][k]);
    }
    __syncwarp();
    wrows(e, lane, 2, pk(T4N, T3), pk(D1, D2));
    prods(e, lane, 5, pk(T1N, T5, X3, T1N, T5), pk(D1, D1, D2, D2, D0),
          pk(T0A, T0B, A1, T0C, A2), 0, b3form);
    if (lane < 6) {
        v[Y][k] = f63_add(v[Y3][k], v[T0A][k]);
        v[X][k] = msub(v[A1][k], v[T0B][k]);
        v[Z][k] = f63_add(v[A2][k], v[T0C][k]);
    }
    __syncwarp();
}

// P + (HX, HY, HZ), the complete addition.
__device__ __forceinline__ void ec_add(EcShared& e, int lane,
                                      int b3form) {
    enum { SXY1 = S9, SXZ1, SYZ1, SXY2, SXZ2, SYZ2, T0, T1, T2, T3, T4, X3B,
           T4B, T5, Z3, X3, T1N, T4N, Y3, T0A, T0B };
    enum { A1 = S9, T0C, A2 };      // the sums are dead by the last step
    u64(*v)[6] = e.v;
    const int k = lane;
    if (lane < 6) {
        v[SXY1][k] = f63_add(v[X][k], v[Y][k]);
        v[SXZ1][k] = f63_add(v[X][k], v[Z][k]);
        v[SYZ1][k] = f63_add(v[Y][k], v[Z][k]);
        v[SXY2][k] = f63_add(v[HX][k], v[HY][k]);
        v[SXZ2][k] = f63_add(v[HX][k], v[HZ][k]);
        v[SYZ2][k] = f63_add(v[HY][k], v[HZ][k]);
    }
    __syncwarp();
    wrows(e, lane, 5, pk(HX, HY, HZ, SXY2, SXZ2), pk(D0, D1, D2, D3, D4));
    prods(e, lane, 5, pk(X, Y, Z, SXY1, SXZ1), pk(D0, D1, D2, D3, D4),
          pk(T0, T1, T2, T3, T4), 0, b3form);
    if (lane < 6) {
        const u64 t0 = v[T0][k], t1 = v[T1][k], t2 = v[T2][k];
        v[T3][k] = msub(v[T3][k], f63_add(t0, t1));
        v[T4][k] = msub(v[T4][k], f63_add(t0, t2));
    }
    __syncwarp();
    wrows(e, lane, 1, pk(SYZ2), pk(D0));
    prods(e, lane, 3, pk(T2, T4, SYZ1), pk(W_B3, W_B3, D0), pk(X3B, T4B, T5),
          3, b3form);
    if (lane < 6) {
        const u64 t0 = v[T0][k], t1 = v[T1][k], t2 = v[T2][k];
        v[T5][k] = msub(v[T5][k], f63_add(t1, t2));
        const u64 z3 = f63_add(v[X3B][k], v[T4][k]);
        v[X3][k] = msub(t1, z3);
        v[Z3][k] = f63_add(t1, z3);
        v[T1N][k] = f63_add(f63_add(mdbl(t0), t0), t2);
        v[T4N][k] = f63_add(v[T4B][k], msub(t0, t2));
    }
    __syncwarp();
    wrows(e, lane, 3, pk(Z3, T4N, T3), pk(D0, D1, D2));
    prods(e, lane, 6, pk(X3, T1N, T5, X3, T1N, T5), pk(D0, D1, D1, D2, D2, D0),
          pk(Y3, T0A, T0B, A1, T0C, A2), 0, b3form);
    if (lane < 6) {
        v[Y][k] = f63_add(v[Y3][k], v[T0A][k]);
        v[X][k] = msub(v[A1][k], v[T0B][k]);
        v[Z][k] = f63_add(v[A2][k], v[T0C][k]);
    }
    __syncwarp();
}

// ---- the affine x of s.G + h.P: X / Z on one lane ------------------------
// fp2 multiply (u^2 = 2u + 2): c0 = u + 2v, c1 = v + c0 + w with u = a0 b0,
// v = a1 b1, w = (a0 - a1)(b1 - b0).
__device__ __forceinline__ void f2mul(const u64* a, const u64* b, u64* c) {
    const u64 u = f63_mmul(a[0], b[0]), v = f63_mmul(a[1], b[1]);
    const u64 w = f63_mmul(msub(a[0], a[1]), msub(b[1], b[0]));
    c[0] = f63_add(u, mdbl(v));
    c[1] = f63_add(f63_add(v, c[0]), w);
}

// x^(p - 2), the base-field inverse (0 maps to 0).
__device__ u64 f63_inv(u64 x) {
    const u64 e = F63_P - 2;
    u64 r = F63_ONE;
#pragma unroll 1
    for (int i = 62; i >= 0; i--) {
        r = f63_msqr(r);
        if (e >> i & 1) r = f63_mmul(r, x);
    }
    return r;
}

// 1 / a in fp6 by the formula of ops/ecc.py `f6_inv` (the reference's
// invert_fp6, which the JAX package's trace uses): fp2 products down to
// the inverse of one fp2 norm, then of one base-field value. Some 60
// Montgomery multiplies and one inverse of 119, against 373 fp6 squarings
// for a^(p^6 - 2); 0 maps to 0 either way.
__device__ void f6inv(const u64* a, u64* out) {
    const u64 *c0 = a, *c1 = a + 2, *c2 = a + 4;
    u64 c0s[2], c1s[2], c2s[2], t[2], x[2], y[2];
    f2mul(c0, c0, c0s);
    f2mul(c1, c1, c1s);
    f2mul(c2, c2, c2s);
    for (int j = 0; j < 2; j++) x[j] = f63_add(c0s[j], c1s[j]);
    f2mul(c0, x, t);
    f2mul(c1, c1s, y);
    for (int j = 0; j < 2; j++) t[j] = msub(t[j], y[j]);
    for (int j = 0; j < 2; j++) x[j] = f63_add(c0[j], msub(c2[j], c1[j]));
    f2mul(x, c2s, y);
    for (int j = 0; j < 2; j++) t[j] = f63_add(t[j], y[j]);
    for (int j = 0; j < 2; j++) x[j] = f63_add(mdbl(c0[j]), c0[j]);
    f2mul(x, c1, y);
    for (int j = 0; j < 2; j++) x[j] = msub(mdbl(c0s[j]), y[j]);
    f2mul(x, c2, y);
    for (int j = 0; j < 2; j++) t[j] = msub(t[j], y[j]);
    // t^-1 = (t0 + 2 t1, -t1) / (t0^2 + 2 t0 t1 - 2 t1^2)
    const u64 t01 = f63_mmul(t[0], t[1]);
    const u64 norm = msub(f63_add(f63_mmul(t[0], t[0]), mdbl(t01)),
                          mdbl(f63_mmul(t[1], t[1])));
    const u64 ni = f63_inv(norm);
    u64 ti[2] = {f63_mmul(f63_add(t[0], mdbl(t[1])), ni),
                 msub(0, f63_mmul(t[1], ni))};
    for (int j = 0; j < 2; j++)
        x[j] = f63_add(f63_add(c0s[j], c1s[j]), c2s[j]);
    u64 z[2];
    for (int j = 0; j < 2; j++) z[j] = msub(mdbl(c0[j]), c1[j]);
    f2mul(z, c2, y);
    for (int j = 0; j < 2; j++) x[j] = msub(x[j], y[j]);
    f2mul(x, ti, out);
    f2mul(c0, c1, x);
    for (int j = 0; j < 2; j++) x[j] = f63_add(x[j], c2s[j]);
    f2mul(x, ti, y);
    for (int j = 0; j < 2; j++) out[2 + j] = msub(0, y[j]);
    f2mul(c0, c2, y);
    for (int j = 0; j < 2; j++) x[j] = f63_add(msub(c1s[j], y[j]), c2s[j]);
    f2mul(x, ti, out + 4);
}

// Slot X = X / Z: the inverse on lane 0, the product split as any other.
__device__ __forceinline__ void ec_affine_x(EcShared& e, int lane) {
    if (lane == 0) f6inv(e.v[Z], e.v[S9]);
    __syncwarp();
    wrows(e, lane, 1, pk(S9), pk(D0));
    prods(e, lane, 1, pk(X), pk(D0), pk(S10), 0, 2);
    if (lane < 6) e.v[X][lane] = e.v[S10][lane];
    __syncwarp();
}

// ---- Rescue on a 16-thread group (csrc/rescue_perm.cu's layout) ----------
// Lane `row` of the MDS product over the lanes 0..13 of this thread's
// group, reduced once; `mask` names the lanes that take part.
__device__ __forceinline__ u64 mds_row(const u64 m[14], u64 s,
                                       unsigned mask) {
    u32 c[4];
    u64 s0 = join32(__shfl_sync(mask, lo32(s), 0, GROUP),
                    __shfl_sync(mask, hi32(s), 0, GROUP));
    f63_mul_wide(m[0], s0, c[0], c[1], c[2], c[3]);
#pragma unroll
    for (int j = 1; j < 14; j++) {
        u64 sj = join32(__shfl_sync(mask, lo32(s), j, GROUP),
                        __shfl_sync(mask, hi32(s), j, GROUP));
        f63_mac(c, m[j], sj);
    }
    return f63_redc_wide(c);
}

// One forward Rescue round r on the group's state, this lane's value s
// (lanes 14-15 run row 0 along; no lane reads them).
__device__ __forceinline__ u64 rescue_round(u64 s, int r, int row,
                                            const u64 m[14],
                                            const u64* __restrict__ ark,
                                            unsigned mask) {
    s = f63_mmul(f63_msqr(s), s);
    s = f63_add(mds_row(m, s, mask), __ldg(ark + r * 28 + row));
    s = f63_inv_sbox(s);
    return f63_add(mds_row(m, s, mask), __ldg(ark + r * 28 + 14 + row));
}

__device__ __forceinline__ u64 shfl64(unsigned mask, u64 v, int src) {
    return join32(__shfl_sync(mask, lo32(v), src, GROUP),
                  __shfl_sync(mask, hi32(v), src, GROUP));
}

// Writes `ncols` buffered columns of 32 rows, from row `row0` of this
// transaction's window: column c of the tile to trace column col(c).
template <typename ColOf>
__device__ __forceinline__ void store_tile(u64 (*tile)[PAD], int ncols,
                                           ColOf col, u64* out_t, long long n,
                                           int row0, int lane) {
    __syncwarp();
    for (int c = 0; c < ncols; c++)
        out_t[(long long)col(c) * n + row0 + lane] = tile[c][lane];
    __syncwarp();
}

// Writes one column's rows [r0, r1) (multiples of 32) of a value that is
// `lo` before row `split` and `hi` from it, with the whole warp.
__device__ __forceinline__ void store_const(u64* out_t, long long n, int col,
                                            int r0, int r1, int split, u64 lo,
                                            u64 hi, int lane) {
    for (int r = r0 + lane; r < r1; r += 32)
        out_t[(long long)col * n + r] = r < split ? lo : hi;
}

struct Shared {
    u64 merkle[2][29][PAD];  // warp 2: cols 0..28; warp 3: cols 29..57
    u64 tail[22][PAD];       // warp 2: cols 42..55, 38..41, 56, 57, 92, 93
    u64 ec[2][19][PAD];      // warps 0 / 1: cols 0..18 / 19..37
    EcShared pt[2];          // warps 0 / 1: s.G / h.P
    u64 root[7];             // R_UPD digest from row thl (PREV_ROOT)
};

__device__ __forceinline__ int tail_col(int c) {
    return c < 14 ? 42 + c : c < 18 ? 24 + c : c < 20 ? 38 + c : 72 + c;
}

// Merkle lane, the S pair of clusters on w = 0 and the R pair on w = 1;
// then w = 1 writes the constant and copy columns.
__device__ void merkle_lane(Shared& sh, int w, int lane, long long t,
                            const u64* __restrict__ init,
                            const u64* __restrict__ sibs,
                            const u64* __restrict__ path_bits,
                            const u64* __restrict__ mds,
                            const u64* __restrict__ ark, int depth,
                            u64* out_t, long long n) {
    const int g = 2 * w + lane / GROUP, l = lane % GROUP;
    const int base = g == 0 ? 0 : g == 1 ? 15 : g == 2 ? 29 : 44;
    // lane 14 of groups 0 and 2 holds the bit register 14 / 43
    const bool owned = l < 14 || (l == 14 && (g & 1) == 0);
    const int col = base + l, c = col - 29 * w;
    const int row = l < 14 ? l : 0;
    const int thl = 8 * depth + 7;
    const u64* inj = sibs + (t * 2 + w) * depth * 7;
    const u64* bits = path_bits + (t * 2 + w) * depth;
    u64 (*tile)[PAD] = sh.merkle[w];
    u64 m[14];
#pragma unroll
    for (int j = 0; j < 14; j++) m[j] = __ldg(mds + row * 14 + j);
    u64 v = owned ? __ldg(init + t * WIDTH + col) : 0;
    if (owned) tile[c][0] = v;
#pragma unroll 1
    for (int step = 0; step < HALF - 1; step++) {
        if (step < thl) {
            const int pos = step & 7, cyc = step >> 3;
            if (pos < 7) {
                const u64 s = rescue_round(v, pos, row, m, ark, FULL);
                if (l < 14) v = s;
            } else {
                // sibling injection (update/trace.rs:96-136): lanes 0..6
                // take the sibling or keep the digest, lanes 7..13 the
                // other, lane 14 the bit
                const u64 bit = __ldg(bits + cyc);
                const int i = l < 7 ? l : l < 14 ? l - 7 : 0;
                const u64 sib = __ldg(inj + cyc * 7 + i);
                const u64 dig = shfl64(FULL, v, l >= 7 && l < 14 ? l - 7 : l);
                v = l < 7 ? (bit ? sib : v)
                  : l < 14 ? (bit ? dig : sib) : bit_m(bit);
            }
        }
        const int r = step + 1;
        if (owned) tile[c][r % TILE] = v;
        if (r % TILE == TILE - 1)
            store_tile(tile, 29, [w](int k) { return 29 * w + k; }, out_t, n,
                       r - (TILE - 1), lane);
    }
    if (w == 0) return;
    if (g == 3 && l < 7) sh.root[l] = v;
    __syncwarp();
    for (int i = 0; i < 7; i++)
        store_const(out_t, n, 58 + i, 0, CYCLE, thl,
                    __ldg(init + t * WIDTH + 58 + i), sh.root[i], lane);
    for (int k = 65; k < 92; k++) {
        const u64 x = __ldg(init + t * WIDTH + k);
        store_const(out_t, n, k, 0, CYCLE, CYCLE, x, x, lane);
    }
    for (int k = 92; k < 94; k++) {
        const u64 x = __ldg(init + t * WIDTH + k);
        store_const(out_t, n, k, 0, HALF, HALF, x, x, lane);
    }
}

// Warp 2, after its Merkle lane: the hash lane on lanes 0..15, the h-limb
// accumulator (38..41) and the range lanes (56 bit, 57 acc; 92 bit, 93 acc)
// on lanes 16..23.
__device__ void hash_range_lane(Shared& sh, int lane, long long t,
                                const u64* __restrict__ rx,
                                const u64* __restrict__ msg,
                                const u64* __restrict__ hbits,
                                const u64* __restrict__ dbits,
                                const u64* __restrict__ gbits,
                                const u64* __restrict__ mds,
                                const u64* __restrict__ ark, u64* out_t,
                                long long n) {
    u64 (*tile)[PAD] = sh.tail;
    const bool hash = lane < GROUP;
    const int l = lane % GROUP;            // hash lane / pure lane index
    const int row = hash && l < 14 ? l : 0;
    const int c = hash ? l : 14 + l;       // tile column, owned when < 22
    const bool owned = hash ? l < 14 : l < 8;
    u64 m[14];
#pragma unroll
    for (int j = 0; j < 14; j++) m[j] = __ldg(mds + row * 14 + j);
    u64 v = hash && l < 6 ? __ldg(rx + t * 6 + l) : 0;
    if (owned) tile[c][0] = v;
    const u64* hb_t = hbits + t * 256;
    const u64* rb_t = (l < 6 ? dbits : gbits) + t * 64;
#pragma unroll 1
    for (int sstep = 0; sstep < HALF - 1; sstep++) {
        if (hash) {
            if (sstep < 40) {
                const int pos = sstep & 7;
                if (pos < 7) {
                    const u64 s = rescue_round(v, pos, row, m, ark, 0xffffu);
                    if (l < 14) v = s;
                } else if (l >= 7 && l < 14) {
                    const long long at = (t * 4 + sstep / 8) * 7 + l - 7;
                    v = sstep < 32 ? __ldg(msg + at) : 0;
                }
            }
        } else if (l < 4) {
            // acc[41 - chunk] = 2 acc + h bit on the even step of each pair
            if (sstep < 510 && (sstep & 1) == 0) {
                const int real = sstep / 2;
                const int chunk = real < 63 ? 0 : (real - 63) / 64 + 1;
                if (3 - chunk == l)
                    v = f63_add(mdbl(v), bit_m(__ldg(hb_t + 254 - real)));
            }
        } else if (l < 8 && sstep < 64) {
            const u64 bit = bit_m(__ldg(rb_t + 63 - sstep));
            v = (l & 1) ? f63_add(mdbl(v), bit) : bit;
        }
        const int r = HALF + sstep + 1;
        if (owned) tile[c][r % TILE] = v;
        if (r % TILE == TILE - 1)
            store_tile(tile, 22, [](int k) { return tail_col(k); }, out_t, n,
                       r - (TILE - 1), lane);
    }
}

// Warps 0-1: one scalar multiplication each, cols 0..18 (s.G, fixed point
// gen12) or 19..37 (h.P, the public key); rows 512..1023. Row 1023 of s.G
// is s.G + h.P with its affine x, after the two warps meet at a barrier.
__device__ void ec_lane(Shared& sh, int pt, int lane,
                        const u64* __restrict__ q12,
                        const u64* __restrict__ bits,
                        const u64* __restrict__ b3g, u64* out_t,
                        long long n) {
    u64 (*tile)[PAD] = sh.ec[pt];
    EcShared& e = sh.pt[pt];
    const int col0 = 19 * pt, k = lane;
    auto col = [col0](int c) { return col0 + c; };
    const u64 b3k = __ldg(b3g + (lane < 6 ? lane : 0));
    // 0: base-subfield b3 (coordinates 1..5 zero), 1: fp2 (2..5 zero), 2
    const int b3form = __any_sync(FULL, lane >= 2 && lane < 6 && b3k) ? 2
                       : __any_sync(FULL, lane == 1 && b3k)          ? 1
                                                                     : 0;
    if (lane < 6) {
        e.v[X][k] = 0;
        e.v[Y][k] = k == 0 ? F63_ONE : 0;
        e.v[Z][k] = 0;
        e.v[QX][k] = __ldg(q12 + k);
        e.v[QY][k] = __ldg(q12 + 6 + k);
        e.v[B3S][k] = b3k;
        e.v[S9][k] = f63_add(e.v[QX][k], e.v[QY][k]);
        tile[k][0] = e.v[X][k];
        tile[6 + k][0] = e.v[Y][k];
        tile[12 + k][0] = e.v[Z][k];
    }
    if (lane == 0) tile[18][0] = 0;
    __syncwarp();
    wrows(e, lane, 4, pk(B3S, QX, QY, S9), pk(W_B3, W_QX, W_QY, W_QXY));
    u64 breg = 0;
#pragma unroll 1
    for (int r = HALF + 1; r < CYCLE; r++) {
        const int sstep = r - HALF - 1;
        if (sstep < 510) {
            const int real = sstep / 2;
            const u64 bit = __ldg(bits + 254 - real);
            breg = bit_m(bit);
            if ((sstep & 1) == 0)
                ec_double(e, lane, b3form);
            else if (bit)
                ec_add_mixed(e, lane, b3form);
        } else {
            // row 1023: h.P hands its point over; s.G adds it
            if (pt == 1 && lane < 6) {
                sh.pt[0].v[HX][k] = e.v[X][k];
                sh.pt[0].v[HY][k] = e.v[Y][k];
                sh.pt[0].v[HZ][k] = e.v[Z][k];
            }
            __syncwarp();
            asm volatile("bar.sync 1, 64;" ::: "memory");
            if (pt == 0) {
                ec_add(e, lane, b3form);
                ec_affine_x(e, lane);
                breg = F63_ONE;
            }
        }
        if (lane < 6) {
            tile[k][r % TILE] = e.v[X][k];
            tile[6 + k][r % TILE] = e.v[Y][k];
            tile[12 + k][r % TILE] = e.v[Z][k];
        }
        if (lane == 0) tile[18][r % TILE] = breg;
        if (r % TILE == TILE - 1)
            store_tile(tile, 19, col, out_t, n, r - (TILE - 1), lane);
    }
}

// Register map (models/transaction.py, models/merkle_update.py): clusters
// 0, 15, 29, 44 (+ bit registers 14, 43); PREV_ROOT 58; copies 65..92;
// Schnorr points 0..17 / 19..36 with bit registers 18 / 37, recomposition
// 38..41, hash state 42..55; delta range 56 / 57; sigma range 92 / 93.
__global__ void __launch_bounds__(THREADS, 1)
transaction_trace_kernel(
    const u64* __restrict__ init,       // [T, 94]
    const u64* __restrict__ sibs,       // [T, 2, depth, 7]
    const u64* __restrict__ path_bits,  // [T, 2, depth]
    const u64* __restrict__ pkey,       // [T, 12]
    const u64* __restrict__ rx,         // [T, 6]
    const u64* __restrict__ sbits,      // [T, 256]
    const u64* __restrict__ hbits,      // [T, 256]
    const u64* __restrict__ msg,        // [T, 4, 7]
    const u64* __restrict__ dbits,      // [T, 64]
    const u64* __restrict__ gbits,      // [T, 64]
    const u64* __restrict__ gen12,      // [12]
    const u64* __restrict__ b3g,        // [6]
    const u64* __restrict__ mds,        // [14, 14]
    const u64* __restrict__ ark,        // [8, 28]
    int depth, long long T, u64* __restrict__ out) {
    __shared__ Shared sh;
    const long long t = blockIdx.x;
    const long long n = T * CYCLE;
    u64* out_t = out + t * CYCLE;
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (w == 0) {
        ec_lane(sh, 0, lane, gen12, sbits + t * 256, b3g, out_t, n);
    } else if (w == 1) {
        ec_lane(sh, 1, lane, pkey + t * 12, hbits + t * 256, b3g, out_t, n);
    } else {
        merkle_lane(sh, w - 2, lane, t, init, sibs, path_bits, mds, ark,
                    depth, out_t, n);
        if (w == 2)
            hash_range_lane(sh, lane, t, rx, msg, hbits, dbits, gbits, mds,
                            ark, out_t, n);
    }
}

// Inputs in the order of ops/kernels.py TRACE_INPUTS, then the constant
// tables gen12, b3, mds, ark (all Montgomery u64 on the device, bits 0/1);
// out: [94, T*1024] u64.
extern "C" int transaction_trace_launch(
    const void* init, const void* sibs, const void* path_bits,
    const void* pkey, const void* rx, const void* sbits, const void* hbits,
    const void* msg, const void* dbits, const void* gbits, const void* gen12,
    const void* b3, const void* mds, const void* ark, int depth, long long T,
    void* out, void* stream) {
    if (T <= 0) return 0;
    transaction_trace_kernel<<<(unsigned)T, THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const u64*)init, (const u64*)sibs, (const u64*)path_bits,
        (const u64*)pkey, (const u64*)rx, (const u64*)sbits,
        (const u64*)hbits, (const u64*)msg, (const u64*)dbits,
        (const u64*)gbits, (const u64*)gen12, (const u64*)b3,
        (const u64*)mds, (const u64*)ark, depth, T, (u64*)out);
    return (int)cudaGetLastError();
}
