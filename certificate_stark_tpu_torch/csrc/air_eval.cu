// The composed state-transition AIR's transition constraints: the 115
// result slots at each point of a domain segment, out [115, S].
//
// Replaces certificate_stark_tpu/models/transaction.py
// `TransactionAir.evaluate_transition` (:237) and the helpers it reaches:
// models/merkle_update.py `evaluate_setup_values` (:200) and
// `evaluate_merkle_auth` (:221), models/schnorr.py `evaluate_schnorr`
// (:146), ops/ecc.py `enforce_point_*` (:377-398) and
// models/constraints.py `rescue_enforce_round` (:6): XLA-fused device code
// on the TPU. The formula sequences are native/air_eval.c's
// (`rescue_enforce` :57, the fp2/fp6/EC helpers :76-233, `schnorr_block`
// :235, `merkle_setup_values` :301, `merkle_auth` :314,
// `eval_transaction_air` :463-561), one point per thread, on f63.cuh's
// word-level Montgomery arithmetic. The plain version is ops/kernels.py
// `transaction_eval_plain` (models/transaction.py
// `TransactionAir.evaluate_transition` through the BASE facade).
//
// Bound on the H100: a point reads 94 + 94 + 48 values and writes 115
// (2.8 KB), and does some 4,000 Montgomery multiplies: nine Rescue round
// constraints (two 14 x 14 MDS layers and 28 cubes each), two projective
// doublings, two mixed additions and one full addition over fp6 (18 base
// multiplies an fp6 multiply), and the flag products. At 2^20 points that
// is ~3 GB against ~50 G 32-bit multiplies: the kernel is bound by the
// multiply rate. What the design does:
// - one thread per point; neighbouring threads take neighbouring points,
//   so every read of a column and every write of a slot coalesces;
// - no input is staged: a thread reads each input column from device
//   memory where it is used (through the read-only cache), so its
//   registers hold one formula's temporaries, not 236 inputs;
// - each result slot is accumulated in place in the thread's own column of
//   the output (zeroed first), not in a local res[115];
// - the nine Rescue round constraints are one loop over a table of
//   (register, slot, flag), the two scalar multiplications' constraints
//   one loop over the two points, so each formula is compiled once;
// - the frames are read through their row strides: cur is a view of the
//   trace LDE (row stride the domain length), nxt the next-row frame;
// - the MDS tables, gen12 and b3 are copied to shared memory once a block;
//   every thread reads the same entry at once (a broadcast). The multiply
//   by b3 is chosen once from its sparsity (a base-subfield scalar, an fp2
//   scalar or a full fp6 value), uniform over the launch;
// - an MDS row sums 14 unreduced 128-bit products and reduces once.
#include <cuda_runtime.h>

#include "f63.cuh"

#define SLOTS 115
#define THREADS 128
#define ONE_M 4287426845256712189ULL  // 2^64 mod p: Montgomery one

__device__ __forceinline__ u64 msub(u64 a, u64 b) {
    return a >= b ? a - b : a + (F63_P - b);
}
__device__ __forceinline__ u64 mdbl(u64 a) { return f63_add(a, a); }

// One thread's point of a [rows, S] array with row stride ld, read-only.
struct Col {
    const u64* __restrict__ p;
    long long ld;
    __device__ __forceinline__ u64 operator[](int r) const {
        return __ldg(p + r * ld);
    }
};

// The thread's column of the output [115, S]: slot s += v.
struct Res {
    u64* __restrict__ p;
    long long ld;
    __device__ __forceinline__ void add(int s, u64 v) const {
        u64* q = p + s * ld;
        *q = f63_add(*q, v);
    }
};

// ---- fp2 / fp6 tower (native/air_eval.c :76-130; ops/ecc.py) -------------
// fp2 = fp[u]/(u^2 - 2u - 2), fp6 = fp2[v]/(v^3 + v + 1); an fp6 value is
// (a0 + a1 u) + (a2 + a3 u) v + (a4 + a5 u) v^2.
struct F6 {
    u64 v[6];
};
// a projective point X || Y || Z
struct Pt {
    u64 v[18];
};

__device__ __forceinline__ void f2mul(u64 a0, u64 a1, u64 b0, u64 b1,
                                      u64& c0, u64& c1) {
    const u64 u = f63_mmul(a0, b0);
    const u64 v = f63_mmul(a1, b1);
    const u64 w = f63_mmul(msub(a0, a1), msub(b1, b0));
    c0 = f63_add(u, mdbl(v));
    c1 = f63_add(f63_add(v, c0), w);
}

__device__ __forceinline__ F6 f6mul(const F6& a, const F6& b) {
    u64 aa[2], bb[2], cc[2], ab[2], ac[2], bc[2];
    f2mul(a.v[0], a.v[1], b.v[0], b.v[1], aa[0], aa[1]);
    f2mul(a.v[2], a.v[3], b.v[2], b.v[3], bb[0], bb[1]);
    f2mul(a.v[4], a.v[5], b.v[4], b.v[5], cc[0], cc[1]);
    f2mul(f63_add(a.v[0], a.v[2]), f63_add(a.v[1], a.v[3]),
          f63_add(b.v[0], b.v[2]), f63_add(b.v[1], b.v[3]), ab[0], ab[1]);
    f2mul(f63_add(a.v[0], a.v[4]), f63_add(a.v[1], a.v[5]),
          f63_add(b.v[0], b.v[4]), f63_add(b.v[1], b.v[5]), ac[0], ac[1]);
    f2mul(f63_add(a.v[2], a.v[4]), f63_add(a.v[3], a.v[5]),
          f63_add(b.v[2], b.v[4]), f63_add(b.v[3], b.v[5]), bc[0], bc[1]);
    F6 c;
#pragma unroll
    for (int j = 0; j < 2; j++) {
        const u64 tmp = f63_add(f63_add(aa[j], bb[j]), cc[j]);
        c.v[j] = msub(tmp, bc[j]);
        c.v[2 + j] = msub(msub(ab[j], bc[j]), aa[j]);
        c.v[4 + j] = f63_add(msub(msub(ac[j], tmp), cc[j]), mdbl(bb[j]));
    }
    return c;
}

__device__ __forceinline__ F6 f6add(const F6& a, const F6& b) {
    F6 c;
#pragma unroll
    for (int i = 0; i < 6; i++) c.v[i] = f63_add(a.v[i], b.v[i]);
    return c;
}
__device__ __forceinline__ F6 f6sub(const F6& a, const F6& b) {
    F6 c;
#pragma unroll
    for (int i = 0; i < 6; i++) c.v[i] = msub(a.v[i], b.v[i]);
    return c;
}
__device__ __forceinline__ F6 f6dbl(const F6& a) { return f6add(a, a); }

// the sparsity of the curve constant b3, uniform over a launch
enum { B3_SUBFIELD = 0, B3_FP2 = 1, B3_FULL = 2 };

// b3 * a (native/air_eval.c f6mulb3 :123): 6, 9 or 18 base multiplies
__device__ __forceinline__ F6 f6mulb3(const F6& a, const F6& b3, int form) {
    F6 c;
    if (form == B3_SUBFIELD) {
#pragma unroll
        for (int i = 0; i < 6; i++) c.v[i] = f63_mmul(a.v[i], b3.v[0]);
    } else if (form == B3_FP2) {
#pragma unroll
        for (int i = 0; i < 3; i++)
            f2mul(a.v[2 * i], a.v[2 * i + 1], b3.v[0], b3.v[1], c.v[2 * i],
                  c.v[2 * i + 1]);
    } else {
        c = f6mul(a, b3);
    }
    return c;
}

__device__ __forceinline__ F6 part(const Pt& p, int k) {
    F6 c;
#pragma unroll
    for (int i = 0; i < 6; i++) c.v[i] = p.v[6 * k + i];
    return c;
}
__device__ __forceinline__ Pt point(const F6& x, const F6& y, const F6& z) {
    Pt p;
#pragma unroll
    for (int i = 0; i < 6; i++) {
        p.v[i] = x.v[i];
        p.v[6 + i] = y.v[i];
        p.v[12 + i] = z.v[i];
    }
    return p;
}
__device__ __forceinline__ F6 f6_at(const Col& a, int c) {
    F6 r;
#pragma unroll
    for (int i = 0; i < 6; i++) r.v[i] = a[c + i];
    return r;
}
__device__ __forceinline__ Pt pt_at(const Col& a, int c) {
    return point(f6_at(a, c), f6_at(a, c + 6), f6_at(a, c + 12));
}

// ---- EC ops on projective points (native/air_eval.c :134-231; ops/ecc.py
// compute_double, compute_add_mixed, compute_add) ---------------------------
__device__ __forceinline__ Pt ec_double(const Pt& pt, const F6& b3, int form) {
    const F6 x = part(pt, 0), y = part(pt, 1), z = part(pt, 2);
    F6 t0 = f6mul(x, x);
    const F6 t1 = f6mul(y, y);
    F6 t2 = f6mul(z, z);
    F6 t3 = f6dbl(f6mul(x, y));
    F6 z3 = f6dbl(f6mul(x, z));
    F6 y3 = f6add(z3, f6mulb3(t2, b3, form));
    F6 x3 = f6sub(t1, y3);
    y3 = f6mul(x3, f6add(t1, y3));
    x3 = f6mul(t3, x3);
    z3 = f6mulb3(z3, b3, form);
    t3 = f6add(f6sub(t0, t2), z3);
    t0 = f6add(f6add(f6dbl(t0), t0), t2);
    t0 = f6mul(t0, t3);
    y3 = f6add(y3, t0);
    t2 = f6dbl(f6mul(y, z));
    t0 = f6mul(t2, t3);
    x3 = f6sub(x3, t0);
    z3 = f6dbl(f6dbl(f6mul(t2, t1)));
    return point(x3, y3, z3);
}

// pt1 + (x2, y2, 1)
__device__ __forceinline__ Pt ec_add_mixed(const Pt& pt1, const F6& x2,
                                           const F6& y2, const F6& b3,
                                           int form) {
    const F6 x1 = part(pt1, 0), y1 = part(pt1, 1), z1 = part(pt1, 2);
    F6 t0 = f6mul(x1, x2);
    F6 t1 = f6mul(y1, y2);
    const F6 t3 = f6sub(f6mul(f6add(x2, y2), f6add(x1, y1)), f6add(t0, t1));
    F6 t4 = f6add(f6mul(x2, z1), x1);
    const F6 t5 = f6add(f6mul(y2, z1), y1);
    F6 z3 = f6add(f6mulb3(z1, b3, form), t4);
    F6 x3 = f6sub(t1, z3);
    z3 = f6add(t1, z3);
    F6 y3 = f6mul(x3, z3);
    t1 = f6add(f6add(f6dbl(t0), t0), z1);
    t4 = f6add(f6mulb3(t4, b3, form), f6sub(t0, z1));
    t0 = f6mul(t1, t4);
    y3 = f6add(y3, t0);
    t0 = f6mul(t5, t4);
    x3 = f6sub(f6mul(t3, x3), t0);
    t0 = f6mul(t3, t1);
    z3 = f6add(f6mul(t5, z3), t0);
    return point(x3, y3, z3);
}

__device__ __forceinline__ Pt ec_add(const Pt& pt1, const Pt& pt2,
                                     const F6& b3, int form) {
    const F6 x1 = part(pt1, 0), y1 = part(pt1, 1), z1 = part(pt1, 2);
    const F6 x2 = part(pt2, 0), y2 = part(pt2, 1), z2 = part(pt2, 2);
    F6 t0 = f6mul(x1, x2);
    F6 t1 = f6mul(y1, y2);
    F6 t2 = f6mul(z1, z2);
    const F6 t3 = f6sub(f6mul(f6add(x1, y1), f6add(x2, y2)), f6add(t0, t1));
    F6 t4 = f6sub(f6mul(f6add(x1, z1), f6add(x2, z2)), f6add(t0, t2));
    const F6 t5 = f6sub(f6mul(f6add(y1, z1), f6add(y2, z2)), f6add(t1, t2));
    F6 z3 = f6add(f6mulb3(t2, b3, form), t4);
    F6 x3 = f6sub(t1, z3);
    z3 = f6add(t1, z3);
    F6 y3 = f6mul(x3, z3);
    t1 = f6add(f6add(f6dbl(t0), t0), t2);
    t4 = f6add(f6mulb3(t4, b3, form), f6sub(t0, t2));
    t0 = f6mul(t1, t4);
    y3 = f6add(y3, t0);
    t0 = f6mul(t5, t4);
    x3 = f6sub(f6mul(t3, x3), t0);
    t0 = f6mul(t3, t1);
    z3 = f6add(f6mul(t5, z3), t0);
    return point(x3, y3, z3);
}

// ---- the nine Rescue round constraints (native/air_eval.c rescue_enforce
// :57; models/constraints.py rescue_enforce_round) ------------------------
// Round i of the table: the state at trace register RESCUE_REG[i], into
// result slots RESCUE_SLOT[i] .. + 13, times periodic flag RESCUE_FLAG[i].
// 0-3: merkle-init rounds at setup (flag setup); 4-7: the Merkle
// authentication clusters (flag hash_mask); 8: the Schnorr message hash
// (flag schnorr_hash).
__constant__ int RESCUE_REG[9] = {0, 15, 29, 44, 0, 15, 29, 44, 42};
__constant__ int RESCUE_SLOT[9] = {0, 14, 28, 42, 0, 15, 29, 44, 42};
__constant__ int RESCUE_FLAG[9] = {0, 0, 0, 0, 4, 4, 4, 4, 12};
#define ARK0 20  // periodic columns of the half-round constants
#define ARK1 34

// one row of a 14 x 14 MDS layer: 14 unreduced products, one reduction
__device__ __forceinline__ u64 mds_row(const u64* m, const u64 s[14]) {
    u32 c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 14; j++) f63_mac(c, m[j], s[j]);  // < 14 p^2 < 2^128
    return f63_redc_wide(c);
}

// slots += flag * (sbox(INV_MDS (nxt - ark1)) - (MDS sbox(cur) + ark0))
__device__ __forceinline__ void rescue_enforce(const Col& cur, const Col& nxt,
                                               const Col& per, int reg,
                                               int slot, u64 flag,
                                               const u64* mds,
                                               const u64* inv_mds,
                                               const Res& res) {
    u64 u[14], s[14];
#pragma unroll
    for (int j = 0; j < 14; j++) s[j] = msub(nxt[reg + j], per[ARK1 + j]);
#pragma unroll
    for (int i = 0; i < 14; i++) {
        const u64 x = mds_row(inv_mds + 14 * i, s);
        u[i] = f63_mmul(x, f63_msqr(x));
    }
#pragma unroll
    for (int j = 0; j < 14; j++) {
        const u64 v = cur[reg + j];
        s[j] = f63_mmul(v, f63_msqr(v));
    }
#pragma unroll
    for (int i = 0; i < 14; i++) {
        const u64 t = f63_add(mds_row(mds + 14 * i, s), per[ARK0 + i]);
        res.add(slot + i, f63_mmul(msub(u[i], t), flag));
    }
}

// ---- the kernel (native/air_eval.c eval_transaction_air :463-561) ---------
// Register map (models/transaction.py, models/merkle_update.py): clusters
// S_INIT 0, S_UPD 15, R_INIT 29, R_UPD 44 (bit registers 14, 43); PREV_ROOT
// 58; copies 65..91 (sender key 65, receiver key 77, delta 89, sigma 90,
// nonce 91); Schnorr points 0..17 / 19..36 with bit registers 18 / 37,
// h-limbs 38..41, hash state 42..55; delta range 56 / 57, sigma range
// 92 / 93. Periodic columns: setup 0, merkle_mask 1, hash_input 2, finish
// 3, hash_mask 4, schnorr_mask 5, scalar_mult 6, doubling 7, digest flags
// 8..11, schnorr_hash 12, internal flags 13..16, range_step 17,
// range_finish 18, value_copy 19, ark0 20..33, ark1 34..47.
__global__ void __launch_bounds__(THREADS)
transaction_eval_kernel(const u64* __restrict__ cur_g, long long cur_ld,
                        const u64* __restrict__ nxt_g, long long nxt_ld,
                        const u64* __restrict__ per_g, long long per_ld,
                        const u64* __restrict__ mds_g,
                        const u64* __restrict__ inv_mds_g,
                        const u64* __restrict__ gen12_g,
                        const u64* __restrict__ b3_g, long long S,
                        u64* __restrict__ out) {
    __shared__ u64 mds[196], inv_mds[196], gen12[12];
    __shared__ F6 b3;
    for (int k = threadIdx.x; k < 196; k += THREADS) {
        mds[k] = mds_g[k];
        inv_mds[k] = inv_mds_g[k];
    }
    if (threadIdx.x < 12) gen12[threadIdx.x] = gen12_g[threadIdx.x];
    if (threadIdx.x < 6) b3.v[threadIdx.x] = b3_g[threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= S) return;
    const int form = (b3.v[2] | b3.v[3] | b3.v[4] | b3.v[5])
                         ? B3_FULL
                         : (b3.v[1] ? B3_FP2 : B3_SUBFIELD);
    const Col c{cur_g + i, cur_ld}, n{nxt_g + i, nxt_ld}, p{per_g + i, per_ld};
    const Res res{out + i, S};
#pragma unroll 1
    for (int s = 0; s < SLOTS; s++) out[s * S + i] = 0;

    // 1. the Rescue round constraints: merkle-init at setup (slots 0..55),
    //    Merkle authentication (0..57), the Schnorr hash (42..55)
#pragma unroll 1
    for (int r = 0; r < 9; r++)
        rescue_enforce(c, n, p, RESCUE_REG[r], RESCUE_SLOT[r],
                       p[RESCUE_FLAG[r]], mds, inv_mds, res);

    // 2. setup value constraints (slots 65..91)
    {
        const u64 setup = p[0];
#pragma unroll 1
        for (int k = 0; k < 12; k++) {
            res.add(65 + k, f63_mmul(msub(c[k], c[15 + k]), setup));
            res.add(77 + k, f63_mmul(msub(c[29 + k], c[44 + k]), setup));
        }
        res.add(89, f63_mmul(msub(c[42], c[57]), setup));
        const u64 bal = msub(msub(c[12], c[27]), msub(c[56], c[41]));
        res.add(90, f63_mmul(bal, setup));
        res.add(91, f63_mmul(msub(c[28], f63_add(c[13], ONE_M)), setup));
    }

    // 3. key / delta / sigma / nonce copies: setup and carry (101..114)
    {
        const u64 setup = p[0], value_copy = p[19];
#pragma unroll 1
        for (int m = 0; m < 2; m++) {
            const int slot = 101 + 2 * m, origin = 29 * m, pos = 65 + 12 * m;
#pragma unroll 1
            for (int k = 0; k < 12; k++) {
                const u64 nv = n[pos + k];
                res.add(slot + k,
                        f63_add(f63_mmul(msub(nv, c[origin + k]), setup),
                                f63_mmul(msub(nv, c[pos + k]), value_copy)));
            }
        }
        const u64 delta_src = msub(c[12], c[27]);
        res.add(105, f63_add(f63_mmul(msub(n[89], delta_src), setup),
                             f63_mmul(msub(n[89], c[89]), value_copy)));
        res.add(106, f63_add(f63_mmul(msub(n[90], c[27]), setup),
                             f63_mmul(msub(n[90], c[90]), value_copy)));
        res.add(107, f63_add(f63_mmul(msub(n[91], c[13]), setup),
                             f63_mmul(msub(n[91], c[91]), value_copy)));
    }

    // 4. Merkle authentication, besides its rounds (slots 0..64, 92..105)
    {
        const u64 tx_hash = p[1], hash_input = p[2], finish = p[3];
        const u64 not_input = msub(ONE_M, f63_add(p[4], hash_input));
        const u64 copy_flag = f63_mmul(tx_hash, not_input);
        const u64 init_flag = f63_mmul(tx_hash, hash_input);
#pragma unroll 1
        for (int m = 0; m < 2; m++) {
            const int base = 29 * m;  // result slots and registers
            const u64 bit = n[base + 14], nbit = msub(ONE_M, bit);
            res.add(base + 14, f63_mmul(msub(f63_msqr(bit), bit), tx_hash));
#pragma unroll 1
            for (int half = 0; half < 2; half++) {
                const int reg = base + 15 * half;
#pragma unroll
                for (int k = 0; k < 7; k++) {
                    const u64 cv = c[reg + k];
                    const u64 d = msub(cv, n[reg + k]);
                    const u64 cp = f63_mmul(d, copy_flag);
                    const u64 ini = f63_mmul(f63_mmul(d, nbit), init_flag);
                    const u64 mv = f63_mmul(
                        f63_mmul(msub(cv, n[reg + 7 + k]), bit), init_flag);
                    res.add(reg + k, f63_add(cp, ini));
                    res.add(reg + 7 + k, mv);
                }
            }
#pragma unroll
            for (int k = 0; k < 7; k++) {
                res.add(base + k,
                        f63_mmul(f63_mmul(msub(n[base + 15 + k], n[base + k]),
                                          bit), init_flag));
                res.add(base + 7 + k,
                        f63_mmul(f63_mmul(msub(n[base + 22 + k],
                                               n[base + 7 + k]), nbit),
                                 init_flag));
            }
        }
        const u64 not_finish = msub(ONE_M, finish);
#pragma unroll 1
        for (int k = 0; k < 7; k++) {
            const u64 root = n[58 + k];
            res.add(58 + k,
                    f63_add(f63_mmul(msub(root, c[58 + k]), not_finish),
                            f63_mmul(msub(root, n[44 + k]), finish)));
            res.add(92 + k, f63_mmul(msub(c[15 + k], c[29 + k]), finish));
            res.add(99 + k, f63_mmul(msub(n[k], c[58 + k]), finish));
        }
    }

    // 5. Schnorr, besides its hash rounds (slots 0..55), with the public
    //    key and the hash's internal inputs from the copy registers
    {
        const u64 schnorr_mask = p[5], scalar_mult = p[6], doubling = p[7];
        const u64 addition = f63_mmul(msub(ONE_M, doubling), scalar_mult);
        const u64 final_flag = f63_mmul(msub(ONE_M, scalar_mult),
                                        schnorr_mask);
        const u64 copy_hash = f63_mmul(msub(ONE_M, p[12]), schnorr_mask);
        // s.G (cols 0..18) and h.P (19..37): doubling and conditional
        // mixed addition of G (gen12) or the public key (copies 65..76)
#pragma unroll 1
        for (int m = 0; m < 2; m++) {
            const int off = 19 * m;
            const Pt pt = pt_at(c, off);
            F6 x2, y2;
#pragma unroll
            for (int k = 0; k < 6; k++) {
                x2.v[k] = m ? n[65 + k] : gen12[k];
                y2.v[k] = m ? n[71 + k] : gen12[6 + k];
            }
            const Pt dbl = ec_double(pt, b3, form);
            const Pt added = ec_add_mixed(pt, x2, y2, b3, form);
            const u64 bit = c[off + 18], nbit = msub(ONE_M, bit);
#pragma unroll
            for (int k = 0; k < 18; k++) {
                const u64 nv = n[off + k];
                const u64 dbl_eq = f63_mmul(msub(nv, dbl.v[k]), doubling);
                const u64 expect = f63_add(f63_mmul(added.v[k], bit),
                                           f63_mmul(pt.v[k], nbit));
                const u64 add_eq = f63_mmul(msub(nv, expect), addition);
                res.add(off + k, f63_add(dbl_eq, add_eq));
            }
            const u64 binc = f63_mmul(msub(f63_msqr(bit), bit), doubling);
            const u64 bitcopy = f63_mmul(msub(bit, n[off + 18]), addition);
            res.add(off + 18, f63_add(binc, bitcopy));
        }
        // S + h.P with the affine-x reduction (slots 0..17)
        {
            const Pt added = ec_add(pt_at(c, 0), pt_at(c, 19), b3, form);
            const F6 xz = f6mul(f6_at(n, 0), part(added, 2));
#pragma unroll
            for (int k = 0; k < 6; k++)
                res.add(k, f63_mmul(msub(xz.v[k], added.v[k]), final_flag));
#pragma unroll
            for (int k = 6; k < 18; k++)
                res.add(k, f63_mmul(msub(n[k], added.v[k]), final_flag));
        }
        // h-limb accumulators (slots 38..41)
        const u64 hbit = n[37];
#pragma unroll 1
        for (int k = 0; k < 4; k++) {
            const int vp = 41 - k;
            const u64 df = p[8 + k];
            const u64 acc = msub(n[vp], f63_add(mdbl(c[vp]), hbit));
            const u64 cp = msub(c[vp], n[vp]);
            res.add(vp, f63_add(
                f63_mmul(acc, f63_mmul(df, doubling)),
                f63_mmul(cp, f63_mmul(msub(ONE_M, df), doubling))));
            const u64 limb = c[38 + k];
            res.add(38 + k,
                    f63_add(f63_mmul(msub(limb, n[38 + k]), addition),
                            f63_mmul(msub(limb, c[42 + k]), final_flag)));
        }
        // the hash rows' copies and rate injection (slots 42..55): the
        // internal inputs are the copy registers 65..88, 89 and 91 under
        // the four internal flags (periodic 13..16)
#pragma unroll 1
        for (int k = 0; k < 7; k++) {
            u64 internal = 0;
#pragma unroll
            for (int f = 0; f < 3; f++)
                internal = f63_add(internal,
                                   f63_mmul(n[65 + 7 * f + k], p[13 + f]));
            if (k < 5)
                internal = f63_add(internal,
                                   f63_mmul(n[k < 4 ? 86 + k : 91], p[16]));
            res.add(42 + k, f63_mmul(msub(c[42 + k], n[42 + k]), copy_hash));
            res.add(49 + k, f63_mmul(msub(n[49 + k], internal), copy_hash));
        }
    }

    // 6. range proofs on delta (56 / 57) and sigma (92 / 93), and the
    //    endpoint equalities (108, 109): the reference's sigma bug
    //    replicated, both compare the DELTA registers
    {
        const u64 range_step = p[17], range_finish = p[18];
#pragma unroll 1
        for (int m = 0; m < 2; m++) {
            const int bp = m ? 92 : 56, ap = bp + 1;
            const u64 bit = n[bp];
            const u64 acc = msub(n[ap], f63_add(mdbl(c[ap]), bit));
            res.add(ap, f63_mmul(acc, range_step));
            res.add(bp, f63_mmul(msub(f63_msqr(bit), bit), range_step));
        }
        const u64 delta_eq = f63_mmul(msub(n[57], n[89]), range_finish);
        res.add(108, delta_eq);
        res.add(109, delta_eq);
    }
}

// cur, nxt [94, S] and periodic [48, S] with their row strides (points
// contiguous); the constant tables mds, inv_mds [14, 14], gen12 [12], b3
// [6]; out [115, S] (all Montgomery u64 on the device).
extern "C" int transaction_eval_launch(const void* cur, long long cur_ld,
                                       const void* nxt, long long nxt_ld,
                                       const void* per, long long per_ld,
                                       const void* mds, const void* inv_mds,
                                       const void* gen12, const void* b3,
                                       long long S, void* out,
                                       void* stream) {
    if (S <= 0) return 0;
    const long long blocks = (S + THREADS - 1) / THREADS;
    transaction_eval_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const u64*)cur, cur_ld, (const u64*)nxt, nxt_ld, (const u64*)per,
        per_ld, (const u64*)mds, (const u64*)inv_mds, (const u64*)gen12,
        (const u64*)b3, S, (u64*)out);
    return (int)cudaGetLastError();
}
