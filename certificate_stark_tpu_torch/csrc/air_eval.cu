// The composed state-transition AIR's transition constraints: the 115
// result slots at each point of a domain segment, out [115, S].
//
// Replaces certificate_stark_tpu/models/transaction.py
// `TransactionAir.evaluate_transition` (:237) and the helpers it reaches:
// models/merkle_update.py `evaluate_setup_values` (:200) and
// `evaluate_merkle_auth` (:221), models/schnorr.py `evaluate_schnorr`
// (:146), ops/ecc.py `enforce_point_*` (:377-398) and
// models/constraints.py `rescue_enforce_round` (:6): XLA-fused device code
// on the TPU. The formulas are native/air_eval.c's (`rescue_enforce` :57,
// the fp2/fp6/EC helpers :76-233, `schnorr_block` :235,
// `merkle_setup_values` :301, `merkle_auth` :314, `eval_transaction_air`
// :463-561) on f63.cuh's word-level Montgomery arithmetic. The plain
// version is ops/kernels.py `transaction_eval_plain`.
//
// Bound on the H100: a point reads 94 + 94 + 48 values and writes 115
// (2.8 KB) and needs 40,848 32-bit multiplies (chip_smoke.py `_eval_muls`,
// fp2 b3): at 2^20 points ~3 GB against ~43 G multiplies, so the kernel is
// bound by the multiply rate. Every other 32-bit integer instruction (the
// adds, compares and selects of the modular arithmetic) issues at that
// same rate, so the kernel's real floor is its whole instruction count,
// some 2.5 times its multiplies (PERF.md §6; scripts/profile_air_eval.py).
// What the design does:
// - a block owns a tile of 32 points and its 8 warps split the point's
//   work into items (ops/kernels.py EVAL_WARPS, handed to the launch as a
//   table): each warp runs its items, one formula at a time, over the 32
//   points, a lane a point, so no warp diverges and a warp's registers
//   hold one formula's live set, not a whole point's;
// - the Rescue round difference sbox(INV_MDS(nxt - ark1)) - (MDS(sbox(cur))
//   + ark0) is computed once for each of the five register bases that the
//   nine flagged round ranges read (EVAL_ROUNDS), and added into each of
//   its ranges times that range's flag: field arithmetic is exact, so
//   this gives the bits of nine separate rounds;
// - the tile's 236 input rows (cur, nxt, periodic) are copied into shared
//   memory once with cp.async (any 8-byte-aligned row stride, so the
//   sharded prover's halo frame too); every item reads its inputs there,
//   a row of 32 points a warp access, free of bank conflicts;
// - slots 0..57, which many items share, are summed in shared memory by
//   compare-and-swap field additions (exact, so the order of the sums
//   changes no bit) and go to out once, coalesced; slots 58..114 belong
//   to one item, which sums each in registers and stores it once: no
//   read-modify-write of out is left in device memory;
// - the projective point formulas (two doublings, two mixed additions, the
//   full addition) run as short programs of fp6 operations (EC_PROGS) over
//   a per-warp scratch in shared memory: one copy of the fp6 multiply
//   serves them all, and a warp holds two fp6 operands in registers at a
//   time;
// - an fp2 product sums its base products unreduced and reduces each
//   coordinate once; an MDS row sums 14 unreduced products and reduces
//   once;
// - two blocks an SM (__launch_bounds__(256, 2): 128 registers a thread,
//   16 warps an SM, 108 KB of shared memory a block); the MDS tables,
//   gen12 and b3 sit in shared memory, read by all lanes at once (a
//   broadcast); the multiply by b3 is chosen once a launch from its
//   sparsity (a base-subfield scalar, an fp2 scalar or a full fp6 value).
#include <cuda_runtime.h>

#include "f63.cuh"

#define TP 32                      // points a tile, one a lane
#define WARPS 8
#define THREADS (WARPS * 32)
#define WIDTH 94
#define NXT0 WIDTH                 // frame rows: cur 0..93, nxt 94..187,
#define PER0 (2 * WIDTH)           // periodic 188..235
#define FRAME_ROWS (2 * WIDTH + 48)
#define SHARED_SLOTS 58            // slots 0..57, summed in shared memory
#define ARK0 20                    // periodic columns of the half-round
#define ARK1 34                    // constants

// The schedule (ops/kernels.py `_eval_schedule`): five rounds of (register
// base, slot a, flag a, slot b, flag b; slot b -1 for none), then each
// warp's items, kind << 3 | parameter, -1 for none; the launch appends each
// warp's first scratch row.
#define NROUND 5
#define ITEMS 3
#define SCHED_IN (5 * NROUND + WARPS * ITEMS)
#define SCHED_LEN (SCHED_IN + WARPS)
enum { K_ROUND, K_DOUBLE, K_MIXED, K_FULL, K_MERKLE, K_HASH, K_RANGE,
       K_OWN, K_KINDS };
struct Sched {
    int v[SCHED_LEN];
};

// shared memory, in u64 from the start: the frame, the shared slots, the
// constant tables, the schedule, then the scratch rows
#define SM_ACC (FRAME_ROWS * TP)
#define SM_MDS (SM_ACC + SHARED_SLOTS * TP)
#define SM_INV (SM_MDS + 196)
#define SM_GEN (SM_INV + 196)
#define SM_B3 (SM_GEN + 12)
#define SM_SCHED (SM_B3 + 6)
#define SM_SCR (SM_SCHED + (SCHED_LEN + 1) / 2)

// a + b for canonical a, b: the sum s = a + b less p wraps below 0
// exactly when s is already below p, and then lies above 2^64 - p > 2^63,
// so its sign bit chooses, as in msub (f63.cuh)
__device__ __forceinline__ u64 madd(u64 a, u64 b) {
    const u64 s = a + b, t = s - F63_P;  // s < 2p < 2^64
    return (long long)t < 0 ? s : t;
}
__device__ __forceinline__ u64 mdbl(u64 a) { return madd(a, a); }

// slot += v in shared memory, exact whatever the order of the warps
__device__ __forceinline__ void acc_add(u64* a, u64 v) {
    u64 seen = *a;
    for (;;) {
        const u64 was = atomicCAS((unsigned long long*)a, seen,
                                  madd(seen, v));
        if (was == seen) return;
        seen = was;
    }
}

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     (u32)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's view of its point in the tile.
struct Tile {
    const u64* f;  // frame + lane: row r at f[r * TP]
    u64* acc;      // shared slots + lane
    __device__ __forceinline__ u64 c(int r) const { return f[r * TP]; }
    __device__ __forceinline__ u64 n(int r) const {
        return f[(NXT0 + r) * TP];
    }
    __device__ __forceinline__ u64 p(int r) const {
        return f[(PER0 + r) * TP];
    }
    __device__ __forceinline__ void add(int s, u64 v) const {
        acc_add(acc + s * TP, v);
    }
};

// ---- fp2 / fp6 tower (native/air_eval.c :76-130; ops/ecc.py) -------------
// fp2 = fp[u]/(u^2 - 2u - 2), fp6 = fp2[v]/(v^3 + v + 1); an fp6 value is
// (a0 + a1 u) + (a2 + a3 u) v + (a4 + a5 u) v^2.
struct F6 {
    u64 v[6];
};

// c0 = a0 b0 + 2 a1 b1 and c1 = a0 b1 + a1 b0 + 2 a1 b1, each summed
// unreduced (< 3 p^2 and < 4 p^2, below 2^128; 2 b1 < 2^64 is a factor as
// it is) and reduced once: five multiply-adds and two reductions, where
// the three Montgomery products of Karatsuba take three reductions and
// five modular additions
__device__ __forceinline__ void f2mul(u64 a0, u64 a1, u64 b0, u64 b1,
                                      u64& c0, u64& c1) {
    const u64 b1x2 = b1 << 1;
    u32 s[4] = {0u, 0u, 0u, 0u}, t[4] = {0u, 0u, 0u, 0u};
    f63_mac(s, a0, b0);
    f63_mac(s, a1, b1x2);
    f63_mac(t, a0, b1);
    f63_mac(t, a1, b0);
    f63_mac(t, a1, b1x2);
    c0 = f63_redc_wide(s);
    c1 = f63_redc_wide(t);
}

__device__ __forceinline__ F6 f6mul(const F6& a, const F6& b) {
    u64 aa[2], bb[2], cc[2], ab[2], ac[2], bc[2];
    f2mul(a.v[0], a.v[1], b.v[0], b.v[1], aa[0], aa[1]);
    f2mul(a.v[2], a.v[3], b.v[2], b.v[3], bb[0], bb[1]);
    f2mul(a.v[4], a.v[5], b.v[4], b.v[5], cc[0], cc[1]);
    f2mul(madd(a.v[0], a.v[2]), madd(a.v[1], a.v[3]),
          madd(b.v[0], b.v[2]), madd(b.v[1], b.v[3]), ab[0], ab[1]);
    f2mul(madd(a.v[0], a.v[4]), madd(a.v[1], a.v[5]),
          madd(b.v[0], b.v[4]), madd(b.v[1], b.v[5]), ac[0], ac[1]);
    f2mul(madd(a.v[2], a.v[4]), madd(a.v[3], a.v[5]),
          madd(b.v[2], b.v[4]), madd(b.v[3], b.v[5]), bc[0], bc[1]);
    F6 c;
#pragma unroll
    for (int j = 0; j < 2; j++) {
        const u64 tmp = madd(madd(aa[j], bb[j]), cc[j]);
        c.v[j] = msub(tmp, bc[j]);
        c.v[2 + j] = msub(msub(ab[j], bc[j]), aa[j]);
        c.v[4 + j] = madd(msub(msub(ac[j], tmp), cc[j]), mdbl(bb[j]));
    }
    return c;
}

__device__ __forceinline__ F6 f6add(const F6& a, const F6& b) {
    F6 c;
#pragma unroll
    for (int i = 0; i < 6; i++) c.v[i] = madd(a.v[i], b.v[i]);
    return c;
}
__device__ __forceinline__ F6 f6sub(const F6& a, const F6& b) {
    F6 c;
#pragma unroll
    for (int i = 0; i < 6; i++) c.v[i] = msub(a.v[i], b.v[i]);
    return c;
}

// the sparsity of the curve constant b3, uniform over a launch
enum { B3_SUBFIELD = 0, B3_FP2 = 1, B3_FULL = 2 };

// b3 * a (native/air_eval.c f6mulb3 :123): 6, 9 or 18 base multiplies
__device__ __forceinline__ F6 f6mulb3(const F6& a, const u64* b3s, int form) {
    F6 c;
    if (form == B3_SUBFIELD) {
        const u64 s = b3s[0];
#pragma unroll
        for (int i = 0; i < 6; i++) c.v[i] = f63_mmul(a.v[i], s);
    } else if (form == B3_FP2) {
        const u64 s0 = b3s[0], s1 = b3s[1];
#pragma unroll
        for (int i = 0; i < 3; i++)
            f2mul(a.v[2 * i], a.v[2 * i + 1], s0, s1, c.v[2 * i],
                  c.v[2 * i + 1]);
    } else {
        F6 b;
#pragma unroll
        for (int i = 0; i < 6; i++) b.v[i] = b3s[i];
        c = f6mul(a, b);
    }
    return c;
}

// ---- the projective point formulas as fp6 programs ------------------------
// An operand byte: space << 6 | row. Spaces: the warp's scratch (rows 6k ..
// 6k + 5 hold value k), the point's cur rows, its nxt rows (both from the
// point's first register), and the mixed addition's affine point (gen12 or
// the public key's copy registers).
enum { SP_SCR, SP_CUR, SP_NXT, SP_PT2 };
#define S_(k) (6 * (k))
#define C_(r) (64 + (r))
#define N_(r) (128 + (r))
#define Q_(r) (192 + (r))
// d = a * b; (a + b) * (c + e); d + a * b; d - a * b; a + b; a - b; 2a;
// 3a + b; b3 * a; and EMIT: the equality rows of coordinate d (0: X,
// 1: Y, 2: Z) from the value a against the target b
enum { OP_MUL, OP_SMUL, OP_MAC, OP_MSC, OP_ADD, OP_SUB, OP_DBL, OP_TRI,
       OP_B3, OP_EMIT };
struct EcOp {
    unsigned char op, d, a, b, c, e;
};

// The three programs, one after another in EC_PROGS:
// 2 * (X, Y, Z) (ops/ecc.py compute_double): 5 scratch values
#define EC_DOUBLE 0
#define N_DOUBLE 28
#define EC_MIXED (EC_DOUBLE + N_DOUBLE)
#define N_MIXED 26
#define EC_FULL (EC_MIXED + N_MIXED)
#define N_FULL 30
__constant__ EcOp EC_PROGS[N_DOUBLE + N_MIXED + N_FULL] = {
    {OP_MUL, S_(0), C_(12), C_(12)},         // t2 = Z^2
    {OP_MUL, S_(1), C_(0), C_(12)},
    {OP_DBL, S_(1), S_(1)},                  // z3 = 2XZ
    {OP_MUL, S_(2), C_(0), C_(0)},           // t0 = X^2
    {OP_B3, S_(3), S_(1)},
    {OP_ADD, S_(3), S_(3), S_(2)},
    {OP_SUB, S_(3), S_(3), S_(0)},           // t3' = t0 - t2 + b3 z3
    {OP_TRI, S_(2), S_(2), S_(0)},           // t0' = 3 t0 + t2
    {OP_MUL, S_(2), S_(2), S_(3)},           // t0' t3'
    {OP_B3, S_(0), S_(0)},
    {OP_ADD, S_(0), S_(1), S_(0)},           // y3 = z3 + b3 t2
    {OP_MUL, S_(1), C_(6), C_(6)},           // t1 = Y^2
    {OP_SUB, S_(4), S_(1), S_(0)},           // x3 = t1 - y3
    {OP_ADD, S_(0), S_(1), S_(0)},
    {OP_MUL, S_(0), S_(4), S_(0)},           // x3 (t1 + y3)
    {OP_ADD, S_(0), S_(0), S_(2)},           // Y
    {OP_EMIT, 1, S_(0), N_(6)},
    {OP_MUL, S_(2), C_(0), C_(6)},
    {OP_DBL, S_(2), S_(2)},                  // 2XY
    {OP_MUL, S_(4), S_(2), S_(4)},           // 2XY x3
    {OP_MUL, S_(2), C_(6), C_(12)},
    {OP_DBL, S_(2), S_(2)},                  // t2' = 2YZ
    {OP_MSC, S_(4), S_(2), S_(3)},           // X = 2XY x3 - t2' t3'
    {OP_EMIT, 0, S_(4), N_(0)},
    {OP_MUL, S_(1), S_(2), S_(1)},
    {OP_DBL, S_(1), S_(1)},
    {OP_DBL, S_(1), S_(1)},                  // Z = 4 t2' t1
    {OP_EMIT, 2, S_(1), N_(12)},
    // (X1, Y1, Z1) + (x2, y2, 1) (ops/ecc.py compute_add_mixed): 6 values
    {OP_MUL, S_(0), C_(0), Q_(0)},           // t0 = X1 x2
    {OP_MUL, S_(1), C_(6), Q_(6)},           // t1 = Y1 y2
    {OP_SMUL, S_(2), Q_(0), Q_(6), C_(0), C_(6)},
    {OP_SUB, S_(2), S_(2), S_(0)},
    {OP_SUB, S_(2), S_(2), S_(1)},           // t3
    {OP_MUL, S_(3), Q_(0), C_(12)},
    {OP_ADD, S_(3), S_(3), C_(0)},           // t4 = x2 Z1 + X1
    {OP_B3, S_(4), C_(12)},
    {OP_ADD, S_(4), S_(4), S_(3)},           // b3 Z1 + t4
    {OP_SUB, S_(5), S_(1), S_(4)},           // x3
    {OP_ADD, S_(4), S_(1), S_(4)},           // z3
    {OP_TRI, S_(1), S_(0), C_(12)},          // t1' = 3 t0 + Z1
    {OP_B3, S_(3), S_(3)},
    {OP_ADD, S_(3), S_(3), S_(0)},
    {OP_SUB, S_(3), S_(3), C_(12)},          // t4' = b3 t4 + t0 - Z1
    {OP_MUL, S_(0), S_(5), S_(4)},
    {OP_MAC, S_(0), S_(1), S_(3)},           // Y = x3 z3 + t1' t4'
    {OP_EMIT, 1, S_(0), N_(6)},
    {OP_MUL, S_(0), Q_(6), C_(12)},
    {OP_ADD, S_(0), S_(0), C_(6)},           // t5 = y2 Z1 + Y1
    {OP_MUL, S_(5), S_(2), S_(5)},
    {OP_MSC, S_(5), S_(0), S_(3)},           // X = t3 x3 - t5 t4'
    {OP_EMIT, 0, S_(5), N_(0)},
    {OP_MUL, S_(4), S_(0), S_(4)},
    {OP_MAC, S_(4), S_(2), S_(1)},           // Z = t5 z3 + t3 t1'
    {OP_EMIT, 2, S_(4), N_(12)},
    // (cur 0..17) + (cur 19..36) (ops/ecc.py compute_add) and the x * Z
    // check against nxt 0..5: 7 values
    {OP_MUL, S_(0), C_(0), C_(19)},          // t0 = X1 X2
    {OP_MUL, S_(1), C_(6), C_(25)},          // t1 = Y1 Y2
    {OP_MUL, S_(2), C_(12), C_(31)},         // t2 = Z1 Z2
    {OP_SMUL, S_(3), C_(0), C_(6), C_(19), C_(25)},
    {OP_SUB, S_(3), S_(3), S_(0)},
    {OP_SUB, S_(3), S_(3), S_(1)},           // t3
    {OP_SMUL, S_(4), C_(6), C_(12), C_(25), C_(31)},
    {OP_SUB, S_(4), S_(4), S_(1)},
    {OP_SUB, S_(4), S_(4), S_(2)},           // t5
    {OP_SMUL, S_(5), C_(0), C_(12), C_(19), C_(31)},
    {OP_SUB, S_(5), S_(5), S_(0)},
    {OP_SUB, S_(5), S_(5), S_(2)},           // t4
    {OP_B3, S_(6), S_(2)},
    {OP_ADD, S_(6), S_(6), S_(5)},           // b3 t2 + t4
    {OP_B3, S_(5), S_(5)},
    {OP_ADD, S_(5), S_(5), S_(0)},
    {OP_SUB, S_(5), S_(5), S_(2)},           // t4' = b3 t4 + t0 - t2
    {OP_TRI, S_(2), S_(0), S_(2)},           // t1' = 3 t0 + t2
    {OP_SUB, S_(0), S_(1), S_(6)},           // x3
    {OP_ADD, S_(6), S_(1), S_(6)},           // z3
    {OP_MUL, S_(1), S_(0), S_(6)},
    {OP_MAC, S_(1), S_(2), S_(5)},           // Y = x3 z3 + t1' t4'
    {OP_EMIT, 1, S_(1), N_(6)},
    {OP_MUL, S_(1), S_(4), S_(6)},
    {OP_MAC, S_(1), S_(3), S_(2)},           // Z = t5 z3 + t3 t1'
    {OP_EMIT, 2, S_(1), N_(12)},
    {OP_MUL, S_(0), S_(3), S_(0)},
    {OP_MSC, S_(0), S_(4), S_(5)},           // X = t3 x3 - t5 t4'
    {OP_MUL, S_(2), N_(0), S_(1)},           // x * Z
    {OP_EMIT, 0, S_(0), S_(2)},
};

// A point formula's context: where its spaces lie, and the flag and blend
// of its equality rows (slot off + 6 coord + e += (target - value) * flag;
// the mixed addition's value is added * bit + cur * (1 - bit)).
struct Ec {
    const u64* cur;  // the point's cur rows (frame + off * TP + lane)
    const u64* nxt;
    const u64* pt2;  // the affine point: gen12 (no lane) or nxt row 65
    int pt2_es;      // its element stride: 1 or TP
    u64* scr;        // the warp's scratch + lane
    u64* acc;        // the shared slots from slot off, + lane
    const u64* b3s;
    int form;
    bool blend;
    u64 flag, bit, nbit;
};

__device__ __forceinline__ const u64* ec_at(const Ec& x, int o, int& es) {
    const int r = o & 63;
    es = TP;
    switch (o >> 6) {
        case SP_SCR: return x.scr + r * TP;
        case SP_CUR: return x.cur + r * TP;
        case SP_NXT: return x.nxt + r * TP;
        default: es = x.pt2_es; return x.pt2 + r * x.pt2_es;
    }
}
__device__ __forceinline__ F6 ld6(const Ec& x, int o) {
    int es;
    const u64* p = ec_at(x, o, es);
    F6 v;
#pragma unroll
    for (int e = 0; e < 6; e++) v.v[e] = p[e * es];
    return v;
}

// EC_PROGS[start .. start + n) on x
__device__ __forceinline__ void run_ec(int start, int n, const Ec& x) {
#pragma unroll 1
    for (int pc = start; pc < start + n; pc++) {
        const EcOp o = EC_PROGS[pc];
        F6 a = ld6(x, o.a);
        if (o.op == OP_EMIT) {
            const F6 t = ld6(x, o.b);
#pragma unroll
            for (int e = 0; e < 6; e++) {
                const int k = 6 * o.d + e;
                u64 val = a.v[e];
                if (x.blend)
                    val = madd(f63_mmul(val, x.bit),
                               f63_mmul(x.cur[k * TP], x.nbit));
                acc_add(x.acc + k * TP, f63_mmul(msub(t.v[e], val), x.flag));
            }
            continue;
        }
        F6 b = a;
        if (o.op == OP_SMUL) {
            a = f6add(a, ld6(x, o.b));
            b = f6add(ld6(x, o.c), ld6(x, o.e));
        } else if (o.op != OP_DBL && o.op != OP_B3) {
            b = ld6(x, o.b);
        }
        F6 r;
        if (o.op <= OP_MSC) r = f6mul(a, b);
        else if (o.op == OP_B3) r = f6mulb3(a, x.b3s, x.form);
        else if (o.op == OP_ADD) r = f6add(a, b);
        else if (o.op == OP_SUB) r = f6sub(a, b);
        else if (o.op == OP_DBL) r = f6add(a, a);
        else r = f6add(f6add(f6add(a, a), a), b);  // OP_TRI
        if (o.op == OP_MAC) r = f6add(ld6(x, o.d), r);
        else if (o.op == OP_MSC) r = f6sub(ld6(x, o.d), r);
        u64* d = x.scr + (o.d & 63) * TP;
#pragma unroll
        for (int e = 0; e < 6; e++) d[e * TP] = r.v[e];
    }
}

// ---- the items -------------------------------------------------------------
// one row of a 14 x 14 MDS layer: 14 unreduced products, one reduction
__device__ __forceinline__ u64 mds_row(const u64* m, const u64 s[14]) {
    u32 c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 14; j++) f63_mac(c, m[j], s[j]);  // < 14 p^2 < 2^128
    return f63_redc_wide(c);
}

// The round difference at register base rd[0] (native/air_eval.c
// rescue_enforce :57; models/constraints.py rescue_enforce_round),
// sbox(INV_MDS(nxt - ark1)) - (MDS(sbox(cur)) + ark0), into slots rd[1] +
// i times periodic flag rd[2], and rd[3] + i times flag rd[4] (rd[3] -1:
// none).
__device__ void item_round(const Tile& t, const int* rd, const u64* mds,
                           const u64* inv_mds) {
    const int reg = rd[0], sa = rd[1], sb = rd[3];
    const u64 fa = t.p(rd[2]), fb = sb >= 0 ? t.p(rd[4]) : 0;
    u64 cb[14], s[14];
#pragma unroll
    for (int j = 0; j < 14; j++) {
        const u64 v = t.c(reg + j);
        cb[j] = f63_mmul(v, f63_msqr(v));
        s[j] = msub(t.n(reg + j), t.p(ARK1 + j));
    }
#pragma unroll 1
    for (int i = 0; i < 14; i++) {
        const u64 x = mds_row(inv_mds + 14 * i, s);
        const u64 d = msub(f63_mmul(x, f63_msqr(x)),
                           madd(mds_row(mds + 14 * i, cb), t.p(ARK0 + i)));
        t.add(sa + i, f63_mmul(d, fa));
        if (sb >= 0) t.add(sb + i, f63_mmul(d, fb));
    }
}

// The point items set up x for their program (run after, from one call
// site) and add their bit rows.
// the doubling of point m (cols 19m .. 19m + 18) and its bit check
// (ops/ecc.py enforce_point_doubling)
__device__ __forceinline__ void item_double(const Tile& t, int m, Ec& x) {
    const int off = 19 * m;
    x.cur = t.f + off * TP;
    x.nxt = t.f + (NXT0 + off) * TP;
    x.acc = t.acc + off * TP;
    x.flag = t.p(7);  // doubling
    x.blend = false;
    const u64 bit = t.c(off + 18);
    t.add(off + 18, f63_mmul(msub(f63_msqr(bit), bit), x.flag));
}

// the conditional mixed addition of G (gen12) or the public key (copies
// 65..76) to point m, and its bit copy (enforce_point_addition_mixed)
__device__ __forceinline__ void item_mixed(const Tile& t, int m,
                                           const u64* gen12, Ec& x) {
    const int off = 19 * m;
    x.cur = t.f + off * TP;
    x.nxt = t.f + (NXT0 + off) * TP;
    x.acc = t.acc + off * TP;
    x.pt2 = m ? t.f + (NXT0 + 65) * TP : gen12;
    x.pt2_es = m ? TP : 1;
    x.flag = f63_mmul(msub(F63_ONE, t.p(7)), t.p(6));  // addition
    x.bit = t.c(off + 18);
    x.nbit = msub(F63_ONE, x.bit);
    x.blend = true;
    t.add(off + 18, f63_mmul(msub(x.bit, t.n(off + 18)), x.flag));
}

// S + h.P with the affine-x reduction, slots 0..17
// (enforce_point_addition_reduce_x)
__device__ __forceinline__ void item_full(const Tile& t, Ec& x) {
    x.cur = t.f;
    x.nxt = t.f + NXT0 * TP;
    x.acc = t.acc;
    x.flag = f63_mmul(msub(F63_ONE, t.p(6)), t.p(5));  // final
    x.blend = false;
}

// Merkle authentication besides its rounds, into slots 0..57 (native/
// air_eval.c merkle_auth :314; models/merkle_update.py evaluate_merkle_auth)
__device__ void item_merkle(const Tile& t) {
    const u64 tx_hash = t.p(1), hash_input = t.p(2);
    const u64 not_input = msub(F63_ONE, madd(t.p(4), hash_input));
    const u64 copy_flag = f63_mmul(tx_hash, not_input);
    const u64 init_flag = f63_mmul(tx_hash, hash_input);
#pragma unroll 1
    for (int m = 0; m < 2; m++) {
        const int base = 29 * m;  // result slots and registers
        const u64 bit = t.n(base + 14), nbit = msub(F63_ONE, bit);
        t.add(base + 14, f63_mmul(msub(f63_msqr(bit), bit), tx_hash));
#pragma unroll 1
        for (int half = 0; half < 2; half++) {
            const int reg = base + 15 * half;
#pragma unroll
            for (int k = 0; k < 7; k++) {
                const u64 cv = t.c(reg + k);
                const u64 d = msub(cv, t.n(reg + k));
                u64 lo = madd(f63_mmul(d, copy_flag),
                                 f63_mmul(f63_mmul(d, nbit), init_flag));
                u64 hi = f63_mmul(f63_mmul(msub(cv, t.n(reg + 7 + k)), bit),
                                  init_flag);
                if (half == 0) {  // the siblings' equalities
                    lo = madd(lo, f63_mmul(f63_mmul(
                        msub(t.n(base + 15 + k), t.n(base + k)), bit),
                        init_flag));
                    hi = madd(hi, f63_mmul(f63_mmul(
                        msub(t.n(base + 22 + k), t.n(base + 7 + k)), nbit),
                        init_flag));
                }
                t.add(reg + k, lo);
                t.add(reg + 7 + k, hi);
            }
        }
    }
}

// Schnorr's h-limb accumulators (slots 38..41) and the hash rows' copies
// and rate injection (42..55), the internal inputs from the copy registers
// 65..88, 89 and 91 under the four internal flags (periodic 13..16)
__device__ void item_hash(const Tile& t) {
    const u64 schnorr_mask = t.p(5), scalar_mult = t.p(6), doubling = t.p(7);
    const u64 addition = f63_mmul(msub(F63_ONE, doubling), scalar_mult);
    const u64 final_flag = f63_mmul(msub(F63_ONE, scalar_mult), schnorr_mask);
    const u64 copy_hash = f63_mmul(msub(F63_ONE, t.p(12)), schnorr_mask);
    const u64 hbit = t.n(37);
#pragma unroll 1
    for (int k = 0; k < 4; k++) {
        const int vp = 41 - k;
        const u64 df = t.p(8 + k);
        const u64 acc = msub(t.n(vp), madd(mdbl(t.c(vp)), hbit));
        const u64 cp = msub(t.c(vp), t.n(vp));
        t.add(vp, madd(
            f63_mmul(acc, f63_mmul(df, doubling)),
            f63_mmul(cp, f63_mmul(msub(F63_ONE, df), doubling))));
        const u64 limb = t.c(38 + k);
        t.add(38 + k, madd(f63_mmul(msub(limb, t.n(38 + k)), addition),
                              f63_mmul(msub(limb, t.c(42 + k)), final_flag)));
    }
#pragma unroll 1
    for (int k = 0; k < 7; k++) {
        u64 internal = 0;
#pragma unroll
        for (int f = 0; f < 3; f++)
            internal = madd(internal,
                               f63_mmul(t.n(65 + 7 * f + k), t.p(13 + f)));
        if (k < 5)
            internal = madd(internal,
                               f63_mmul(t.n(k < 4 ? 86 + k : 91), t.p(16)));
        t.add(42 + k, f63_mmul(msub(t.c(42 + k), t.n(42 + k)), copy_hash));
        t.add(49 + k, f63_mmul(msub(t.n(49 + k), internal), copy_hash));
    }
}

// the range proof on delta: bit (slot 56) and accumulator (57)
__device__ void item_range(const Tile& t) {
    const u64 range_step = t.p(17), bit = t.n(56);
    const u64 acc = msub(t.n(57), madd(mdbl(t.c(57)), bit));
    t.add(57, f63_mmul(acc, range_step));
    t.add(56, f63_mmul(msub(f63_msqr(bit), bit), range_step));
}

// Slots 58..114, which no other item writes: the root registers, the setup
// values, Merkle's finish rows, the sigma range proof, the key / delta /
// sigma / nonce copies and the endpoint equalities (the reference's sigma
// bug replicated: both compare the DELTA registers). Each slot is summed
// in registers and stored once to o (out + the point; row stride S).
__device__ void item_own(const Tile& t, u64* o, long long S, bool live) {
    const u64 setup = t.p(0), finish = t.p(3), range_step = t.p(17);
    const u64 range_finish = t.p(18), value_copy = t.p(19);
    const u64 not_finish = msub(F63_ONE, finish);
#define PUT(s, v)                  \
    do {                           \
        const u64 v_ = (v);        \
        if (live) o[(s) * S] = v_; \
    } while (0)
#pragma unroll 1
    for (int k = 0; k < 7; k++) {
        const u64 root = t.n(58 + k);
        PUT(58 + k, madd(f63_mmul(msub(root, t.c(58 + k)), not_finish),
                            f63_mmul(msub(root, t.n(44 + k)), finish)));
    }
#pragma unroll 1
    for (int k = 0; k < 12; k++) {
        PUT(65 + k, f63_mmul(msub(t.c(k), t.c(15 + k)), setup));
        PUT(77 + k, f63_mmul(msub(t.c(29 + k), t.c(44 + k)), setup));
    }
    PUT(89, f63_mmul(msub(t.c(42), t.c(57)), setup));
    const u64 bal = msub(msub(t.c(12), t.c(27)), msub(t.c(56), t.c(41)));
    PUT(90, f63_mmul(bal, setup));
    PUT(91, f63_mmul(msub(t.c(28), madd(t.c(13), F63_ONE)), setup));
    {  // Merkle's finish rows, with sigma's range bit (92), accumulator (93)
        const u64 bit = t.n(92);
        const u64 acc = msub(t.n(93), madd(mdbl(t.c(93)), bit));
        PUT(92, madd(f63_mmul(msub(t.c(15), t.c(29)), finish),
                        f63_mmul(msub(f63_msqr(bit), bit), range_step)));
        PUT(93, madd(f63_mmul(msub(t.c(16), t.c(30)), finish),
                        f63_mmul(acc, range_step)));
    }
#pragma unroll 1
    for (int k = 2; k < 7; k++)
        PUT(92 + k, f63_mmul(msub(t.c(15 + k), t.c(29 + k)), finish));
    u64 w[16];  // slots 99..114
#pragma unroll
    for (int k = 0; k < 16; k++)
        w[k] = k < 7 ? f63_mmul(msub(t.n(k), t.c(58 + k)), finish) : 0;
#pragma unroll
    for (int m = 0; m < 2; m++) {  // the keys: slots 101 + 2m ..
        const int origin = 29 * m, pos = 65 + 12 * m;
#pragma unroll
        for (int k = 0; k < 12; k++) {
            const u64 nv = t.n(pos + k);
            w[2 + 2 * m + k] = madd(
                w[2 + 2 * m + k],
                madd(f63_mmul(msub(nv, t.c(origin + k)), setup),
                        f63_mmul(msub(nv, t.c(pos + k)), value_copy)));
        }
    }
    const u64 delta_src = msub(t.c(12), t.c(27));
    w[6] = madd(w[6], madd(f63_mmul(msub(t.n(89), delta_src), setup),
                                 f63_mmul(msub(t.n(89), t.c(89)),
                                          value_copy)));
    w[7] = madd(w[7], madd(f63_mmul(msub(t.n(90), t.c(27)), setup),
                                 f63_mmul(msub(t.n(90), t.c(90)),
                                          value_copy)));
    w[8] = madd(w[8], madd(f63_mmul(msub(t.n(91), t.c(13)), setup),
                                 f63_mmul(msub(t.n(91), t.c(91)),
                                          value_copy)));
    const u64 delta_eq = f63_mmul(msub(t.n(57), t.n(89)), range_finish);
    w[9] = madd(w[9], delta_eq);
    w[10] = madd(w[10], delta_eq);
#pragma unroll
    for (int k = 0; k < 16; k++) PUT(99 + k, w[k]);
#undef PUT
}

// ---- the kernel --------------------------------------------------------------
// Register map (models/transaction.py, models/merkle_update.py): clusters
// S_INIT 0, S_UPD 15, R_INIT 29, R_UPD 44 (bit registers 14, 43); PREV_ROOT
// 58; copies 65..91 (sender key 65, receiver key 77, delta 89, sigma 90,
// nonce 91); Schnorr points 0..17 / 19..36 with bit registers 18 / 37,
// h-limbs 38..41, hash state 42..55; delta range 56 / 57, sigma range
// 92 / 93. Periodic columns: setup 0, merkle_mask 1, hash_input 2, finish
// 3, hash_mask 4, schnorr_mask 5, scalar_mult 6, doubling 7, digest flags
// 8..11, schnorr_hash 12, internal flags 13..16, range_step 17,
// range_finish 18, value_copy 19, ark0 20..33, ark1 34..47.
__global__ void __launch_bounds__(THREADS, 2)
transaction_eval_kernel(const u64* __restrict__ cur_g, long long cur_ld,
                        const u64* __restrict__ nxt_g, long long nxt_ld,
                        const u64* __restrict__ per_g, long long per_ld,
                        const u64* __restrict__ mds_g,
                        const u64* __restrict__ inv_mds_g,
                        const u64* __restrict__ gen12_g,
                        const u64* __restrict__ b3_g, long long S,
                        u64* __restrict__ out, const Sched sched) {
    extern __shared__ u64 sm[];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const long long p0 = (long long)blockIdx.x * TP;
    // 1. the tile's 236 frame rows, in flight at once (a point past S reads
    //    point S - 1; its results are not stored)
    for (int e = tid; e < FRAME_ROWS * TP; e += THREADS) {
        const int r = e / TP;
        long long p = p0 + e % TP;
        p = p < S ? p : S - 1;
        const u64* src = r < NXT0   ? cur_g + r * cur_ld + p
                         : r < PER0 ? nxt_g + (r - NXT0) * nxt_ld + p
                                    : per_g + (r - PER0) * per_ld + p;
        cp_async8(sm + e, src);
    }
    // 2. meanwhile the constant tables, the schedule, the zeroed slots
    u64* acc = sm + SM_ACC;
    int* sch = (int*)(sm + SM_SCHED);
    for (int k = tid; k < 196; k += THREADS) {
        sm[SM_MDS + k] = mds_g[k];
        sm[SM_INV + k] = inv_mds_g[k];
    }
    if (tid < 12) sm[SM_GEN + tid] = gen12_g[tid];
    if (tid < 6) sm[SM_B3 + tid] = b3_g[tid];
    if (tid == 0) {
#pragma unroll
        for (int k = 0; k < SCHED_LEN; k++) sch[k] = sched.v[k];
    }
    for (int k = tid; k < SHARED_SLOTS * TP; k += THREADS) acc[k] = 0;
    cp_async_wait_all();
    __syncthreads();

    // 3. the warp's items
    const u64* b3s = sm + SM_B3;
    const Tile t{sm + lane, acc + lane};
    Ec x;
    x.scr = sm + SM_SCR + sch[SCHED_IN + w] * TP + lane;
    x.b3s = b3s;
    x.form = (b3s[2] | b3s[3] | b3s[4] | b3s[5])
                 ? B3_FULL
                 : (b3s[1] ? B3_FP2 : B3_SUBFIELD);
    x.pt2 = sm + SM_GEN;
    x.pt2_es = 1;
    x.bit = x.nbit = 0;
    const long long p = p0 + lane;
#pragma unroll 1
    for (int k = 0; k < ITEMS; k++) {
        const int code = sch[5 * NROUND + ITEMS * w + k];
        if (code < 0) break;
        const int param = code & 7;
        int start = 0, n = 0;  // the point formula's program, if any
        switch (code >> 3) {
            case K_ROUND:
                item_round(t, sch + 5 * param, sm + SM_MDS, sm + SM_INV);
                break;
            case K_DOUBLE:
                item_double(t, param, x);
                start = EC_DOUBLE, n = N_DOUBLE;
                break;
            case K_MIXED:
                item_mixed(t, param, sm + SM_GEN, x);
                start = EC_MIXED, n = N_MIXED;
                break;
            case K_FULL:
                item_full(t, x);
                start = EC_FULL, n = N_FULL;
                break;
            case K_MERKLE: item_merkle(t); break;
            case K_HASH: item_hash(t); break;
            case K_RANGE: item_range(t); break;
            default: item_own(t, out + p, S, p < S); break;
        }
        if (n) run_ec(start, n, x);
    }
    __syncthreads();

    // 4. the shared slots to out, a row of 32 points at a time
    for (int k = tid; k < SHARED_SLOTS * TP; k += THREADS) {
        const long long q = p0 + k % TP;
        if (q < S) out[(k / TP) * S + q] = acc[k];
    }
}

// ---- host side ---------------------------------------------------------------
// scratch values a point formula needs
static int scratch_values(int kind) {
    return kind == K_DOUBLE ? 5 : kind == K_MIXED ? 6 : kind == K_FULL ? 7 : 0;
}

// Checks the schedule (every item once: the five rounds, both points'
// doubling and mixed addition, the full addition, merkle, hash, range,
// own), lays out each warp's scratch, and returns the dynamic shared
// memory bytes, or -1 for a schedule the kernel cannot run.
static long long layout(const int* sched, int n, Sched* out) {
    if (n != SCHED_IN) return -1;
    static const int count[K_KINDS] = {NROUND, 2, 2, 1, 1, 1, 1, 1};
    int seen[K_KINDS][8] = {};
    for (int r = 0; r < NROUND; r++) {
        const int* rd = sched + 5 * r;
        if (rd[0] < 0 || rd[0] + 14 > WIDTH || rd[1] < 0 ||
            rd[1] + 14 > SHARED_SLOTS || rd[2] < 0 || rd[2] >= ARK0 ||
            rd[3] < -1 || rd[3] + 14 > SHARED_SLOTS ||
            (rd[3] >= 0 && (rd[4] < 0 || rd[4] >= ARK0)))
            return -1;
    }
    int rows = 0;
    for (int w = 0; w < WARPS; w++) {
        int need = 0, ended = 0;
        for (int k = 0; k < ITEMS; k++) {
            const int code = sched[5 * NROUND + ITEMS * w + k];
            if (code < 0) {
                ended = 1;
                continue;
            }
            const int kind = code >> 3, param = code & 7;
            if (ended || kind >= K_KINDS || param >= count[kind] ||
                seen[kind][param]++)
                return -1;
            need = scratch_values(kind) > need ? scratch_values(kind) : need;
        }
        out->v[SCHED_IN + w] = rows;
        rows += 6 * need;
    }
    for (int kind = 0; kind < K_KINDS; kind++)
        for (int param = 0; param < count[kind]; param++)
            if (!seen[kind][param]) return -1;
    for (int k = 0; k < SCHED_IN; k++) out->v[k] = sched[k];
    return (long long)(SM_SCR + rows * TP) * 8;
}

static int prepare(const int* sched, int n, Sched* s, int* smem) {
    const long long bytes = layout(sched, n, s);
    if (bytes < 0) return (int)cudaErrorInvalidValue;
    *smem = (int)bytes;
    cudaError_t e = cudaFuncSetAttribute(
        transaction_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        *smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            transaction_eval_kernel,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    return (int)e;
}

// cur, nxt [94, S] and periodic [48, S] with their row strides (points
// contiguous, 8-byte aligned); the constant tables mds, inv_mds [14, 14],
// gen12 [12], b3 [6]; out [115, S] (all Montgomery u64 on the device);
// the schedule (host ints, SCHED_IN of them).
extern "C" int transaction_eval_launch(const void* cur, long long cur_ld,
                                       const void* nxt, long long nxt_ld,
                                       const void* per, long long per_ld,
                                       const void* mds, const void* inv_mds,
                                       const void* gen12, const void* b3,
                                       long long S, void* out,
                                       const int* sched, int n_sched,
                                       void* stream) {
    Sched s;
    int smem;
    int rc = prepare(sched, n_sched, &s, &smem);
    if (rc != 0 || S <= 0) return rc;
    const long long blocks = (S + TP - 1) / TP;
    transaction_eval_kernel<<<(unsigned)blocks, THREADS, smem,
                              (cudaStream_t)stream>>>(
        (const u64*)cur, cur_ld, (const u64*)nxt, nxt_ld, (const u64*)per,
        per_ld, (const u64*)mds, (const u64*)inv_mds, (const u64*)gen12,
        (const u64*)b3, S, (u64*)out, s);
    return (int)cudaGetLastError();
}

// The launch's shape for a schedule: dynamic shared memory bytes a block,
// resident blocks an SM, threads a block and points a tile.
extern "C" int transaction_eval_occupancy(const int* sched, int n_sched,
                                          int* smem, int* blocks,
                                          int* threads, int* tile) {
    Sched s;
    int rc = prepare(sched, n_sched, &s, smem);
    if (rc != 0) return rc;
    *threads = THREADS;
    *tile = TP;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, transaction_eval_kernel, THREADS, *smem);
}
