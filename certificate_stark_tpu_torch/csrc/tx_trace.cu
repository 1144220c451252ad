// The composed state-transition AIR's trace: T transaction windows of 1024
// rows over 94 columns, written as the Montgomery trace [94, T*1024].
//
// Replaces certificate_stark_tpu/models/trace_device.py `build_trace_device`
// (:36-119, lax.scan lanes in XLA). Template, nearly line for line:
// native/air_eval.c `transaction_trace` (:670-806) and its helpers
// `tx_rescue_round` (:637), `tx_inject` (:655), `ec_double` (:134),
// `ec_add_mixed` (:163), `ec_add` (:196), `f6mul` (:85), `f6mulb3` (:123)
// and `f6inv` (:620), with f63.cuh's word-level Montgomery arithmetic.
// The plain version is models/trace_device.py `build_trace_plain`.
//
// Bound on the H100: one transaction is a chain of some 10^6 dependent
// Montgomery multiplies (Rescue rounds on four clusters, then 255
// double-and-add steps of two fp6 scalar multiplications), and it writes
// 752 KB. One thread runs one transaction, so at 128 transactions the
// kernel is 4 warps on 4 SMs and bound by the latency of that chain, not by
// the card's multiply rate or memory. What the design does: a simple kernel
// that is right first. Each thread keeps its 94-column state in local
// memory (cached in L1), takes the fp6 products as 18 base products, sums
// each Rescue MDS row unreduced and reduces once, and raises to 1/alpha
// with the addition chain of f63_inv_sbox; a warp is a block, so the warps
// land on different SMs.
#include <cuda_runtime.h>

#include "f63.cuh"

#define WIDTH 94
#define CYCLE 1024
#define THREADS 32
#define ONE_M 4287426845256712189ULL  // 2^64 mod p: Montgomery one

__device__ __forceinline__ u64 msub(u64 a, u64 b) {
    return a >= b ? a - b : a + (F63_P - b);
}
__device__ __forceinline__ u64 mdbl(u64 a) { return f63_add(a, a); }

// ---- fp2 / fp6 tower (ops/ecc.py, reference ecc.rs:424-548) --------------
__device__ __forceinline__ void f2mul(const u64* a, const u64* b, u64* c) {
    u64 u = f63_mmul(a[0], b[0]);
    u64 v = f63_mmul(a[1], b[1]);
    u64 w = f63_mmul(msub(a[0], a[1]), msub(b[1], b[0]));
    u64 c0 = f63_add(u, mdbl(v));
    c[0] = c0;
    c[1] = f63_add(f63_add(v, c0), w);
}

__device__ void f6mul(const u64* a, const u64* b, u64* c) {
    u64 aa[2], bb[2], cc[2], ab[2], ac[2], bc[2], x[2], y[2];
    f2mul(a, b, aa);
    f2mul(a + 2, b + 2, bb);
    f2mul(a + 4, b + 4, cc);
    x[0] = f63_add(a[0], a[2]); x[1] = f63_add(a[1], a[3]);
    y[0] = f63_add(b[0], b[2]); y[1] = f63_add(b[1], b[3]);
    f2mul(x, y, ab);
    x[0] = f63_add(a[0], a[4]); x[1] = f63_add(a[1], a[5]);
    y[0] = f63_add(b[0], b[4]); y[1] = f63_add(b[1], b[5]);
    f2mul(x, y, ac);
    x[0] = f63_add(a[2], a[4]); x[1] = f63_add(a[3], a[5]);
    y[0] = f63_add(b[2], b[4]); y[1] = f63_add(b[3], b[5]);
    f2mul(x, y, bc);
    for (int j = 0; j < 2; j++) {
        u64 tmp = f63_add(f63_add(aa[j], bb[j]), cc[j]);
        c[j] = msub(tmp, bc[j]);
        c[2 + j] = msub(msub(ab[j], bc[j]), aa[j]);
        c[4 + j] = f63_add(msub(msub(ac[j], tmp), cc[j]), mdbl(bb[j]));
    }
}

__device__ __forceinline__ void f6add(const u64* a, const u64* b, u64* c) {
    for (int i = 0; i < 6; i++) c[i] = f63_add(a[i], b[i]);
}
__device__ __forceinline__ void f6sub(const u64* a, const u64* b, u64* c) {
    for (int i = 0; i < 6; i++) c[i] = msub(a[i], b[i]);
}
__device__ __forceinline__ void f6dbl(u64* a) {
    for (int i = 0; i < 6; i++) a[i] = mdbl(a[i]);
}

// b3 * a in fp6 by the sparsity of the curve constant: a base-subfield
// scalar (coordinates 1..5 zero), an fp2 scalar (2..5 zero; three fp2
// multiplies) or a full fp6 element. Safe when c aliases a.
__device__ void f6mulb3(const u64* a, const u64* b3, u64* c) {
    if (!(b3[2] | b3[3] | b3[4] | b3[5])) {
        if (!b3[1]) {
            for (int i = 0; i < 6; i++) c[i] = f63_mmul(a[i], b3[0]);
            return;
        }
        for (int i = 0; i < 3; i++) f2mul(a + 2 * i, b3, c + 2 * i);
        return;
    }
    u64 t[6];
    f6mul(a, b3, t);
    for (int i = 0; i < 6; i++) c[i] = t[i];
}

// a^(p^6 - 2), the fp6 inverse; exponent words little-endian.
__device__ void f6inv(const u64* a, u64* out) {
    const u64 e[6] = {0x88ffffffffffffffULL, 0xfb61c00000000001ULL,
                      0x55c2038000000000ULL, 0x1074daebf0000000ULL,
                      0x01af28ce25900000ULL, 0x001262d2ca6f6400ULL};
    u64 r[6] = {ONE_M, 0, 0, 0, 0, 0}, base[6], t[6];
    for (int i = 0; i < 6; i++) base[i] = a[i];
    for (int w = 0; w < 6; w++) {
        u64 bits = e[w];
        for (int b = 0; b < 64; b++) {
            if (bits & 1) {
                f6mul(r, base, t);
                for (int i = 0; i < 6; i++) r[i] = t[i];
            }
            bits >>= 1;
            f6mul(base, base, t);
            for (int i = 0; i < 6; i++) base[i] = t[i];
        }
    }
    for (int i = 0; i < 6; i++) out[i] = r[i];
}

// ---- point ops on projective [X||Y||Z] (ops/ecc.py compute_*) ------------
__device__ void ec_double(const u64* pt, const u64* b3, u64* o) {
    const u64 *x = pt, *y = pt + 6, *z = pt + 12;
    u64 t0[6], t1[6], t2[6], t3[6], x3[6], y3[6], z3[6], tm[6];
    f6mul(x, x, t0);
    f6mul(y, y, t1);
    f6mul(z, z, t2);
    f6mul(x, y, t3); f6dbl(t3);
    f6mul(x, z, z3); f6dbl(z3);
    f6mulb3(t2, b3, y3);
    f6add(z3, y3, y3);
    f6sub(t1, y3, x3);
    f6add(t1, y3, y3);
    f6mul(x3, y3, tm); for (int i = 0; i < 6; i++) y3[i] = tm[i];
    f6mul(t3, x3, tm); for (int i = 0; i < 6; i++) x3[i] = tm[i];
    f6mulb3(z3, b3, z3);
    f6sub(t0, t2, t3);
    f6add(t3, z3, t3);
    for (int i = 0; i < 6; i++) tm[i] = mdbl(t0[i]);
    f6add(tm, t0, t0);
    f6add(t0, t2, t0);
    f6mul(t0, t3, tm); for (int i = 0; i < 6; i++) t0[i] = tm[i];
    f6add(y3, t0, y3);
    f6mul(y, z, t2); f6dbl(t2);
    f6mul(t2, t3, t0);
    f6sub(x3, t0, x3);
    f6mul(t2, t1, z3); f6dbl(z3); f6dbl(z3);
    for (int i = 0; i < 6; i++) {
        o[i] = x3[i]; o[6 + i] = y3[i]; o[12 + i] = z3[i];
    }
}

__device__ void ec_add_mixed(const u64* pt1, const u64* pt2, const u64* b3,
                             u64* o) {
    const u64 *x1 = pt1, *y1 = pt1 + 6, *z1 = pt1 + 12;
    const u64 *x2 = pt2, *y2 = pt2 + 6;
    u64 t0[6], t1[6], t2[6], t3[6], t4[6], t5[6], x3[6], y3[6], z3[6];
    u64 a[6], b[6];
    f6mul(x1, x2, t0);
    f6mul(y1, y2, t1);
    f6add(x2, y2, a); f6add(x1, y1, b);
    f6mul(a, b, t3);
    f6add(t0, t1, a);
    f6sub(t3, a, t3);
    f6mul(x2, z1, t4); f6add(t4, x1, t4);
    f6mul(y2, z1, t5); f6add(t5, y1, t5);
    f6mulb3(z1, b3, x3);
    f6add(x3, t4, z3);
    f6sub(t1, z3, x3);
    f6add(t1, z3, z3);
    f6mul(x3, z3, y3);
    for (int i = 0; i < 6; i++) t1[i] = f63_add(mdbl(t0[i]), t0[i]);
    f6mulb3(t4, b3, t4);
    f6add(t1, z1, t1);
    f6sub(t0, z1, t2);
    f6add(t4, t2, t4);
    f6mul(t1, t4, t0);
    f6add(y3, t0, y3);
    f6mul(t5, t4, t0);
    f6mul(t3, x3, a);
    f6sub(a, t0, x3);
    f6mul(t3, t1, t0);
    f6mul(t5, z3, a);
    f6add(a, t0, z3);
    for (int i = 0; i < 6; i++) {
        o[i] = x3[i]; o[6 + i] = y3[i]; o[12 + i] = z3[i];
    }
}

__device__ void ec_add(const u64* pt1, const u64* pt2, const u64* b3, u64* o) {
    const u64 *x1 = pt1, *y1 = pt1 + 6, *z1 = pt1 + 12;
    const u64 *x2 = pt2, *y2 = pt2 + 6, *z2 = pt2 + 12;
    u64 t0[6], t1[6], t2[6], t3[6], t4[6], t5[6], x3[6], y3[6], z3[6];
    u64 a[6], b[6];
    f6mul(x1, x2, t0);
    f6mul(y1, y2, t1);
    f6mul(z1, z2, t2);
    f6add(x1, y1, a); f6add(x2, y2, b);
    f6mul(a, b, t3);
    f6add(t0, t1, a); f6sub(t3, a, t3);
    f6add(x1, z1, a); f6add(x2, z2, b);
    f6mul(a, b, t4);
    f6add(t0, t2, a); f6sub(t4, a, t4);
    f6add(y1, z1, a); f6add(y2, z2, b);
    f6mul(a, b, t5);
    f6add(t1, t2, a); f6sub(t5, a, t5);
    f6mulb3(t2, b3, x3);
    f6add(x3, t4, z3);
    f6sub(t1, z3, x3);
    f6add(t1, z3, z3);
    f6mul(x3, z3, y3);
    for (int i = 0; i < 6; i++) t1[i] = f63_add(mdbl(t0[i]), t0[i]);
    f6mulb3(t4, b3, t4);
    f6add(t1, t2, t1);
    f6sub(t0, t2, t2);
    f6add(t4, t2, t4);
    f6mul(t1, t4, t0);
    f6add(y3, t0, y3);
    f6mul(t5, t4, t0);
    f6mul(t3, x3, a);
    f6sub(a, t0, x3);
    f6mul(t3, t1, t0);
    f6mul(t5, z3, a);
    f6add(a, t0, z3);
    for (int i = 0; i < 6; i++) {
        o[i] = x3[i]; o[6 + i] = y3[i]; o[12 + i] = z3[i];
    }
}

// ---- Rescue round and sibling injection ----------------------------------
// MDS row i of s: 14 unreduced products summed, reduced once.
__device__ __forceinline__ u64 mds_row(const u64* __restrict__ mds, int i,
                                       const u64* s) {
    u32 c[4];
    f63_mul_wide(__ldg(mds + i * 14), s[0], c[0], c[1], c[2], c[3]);
    for (int j = 1; j < 14; j++) f63_mac(c, __ldg(mds + i * 14 + j), s[j]);
    return f63_redc_wide(c);
}

// One forward Rescue round on a 14-element state slice, ark row r.
__device__ void rescue_round(u64* st, int r, const u64* __restrict__ mds,
                             const u64* __restrict__ ark) {
    u64 tmp[14];
    for (int i = 0; i < 14; i++) st[i] = f63_mmul(f63_msqr(st[i]), st[i]);
    for (int i = 0; i < 14; i++)
        tmp[i] = f63_add(mds_row(mds, i, st), __ldg(ark + r * 28 + i));
    for (int i = 0; i < 14; i++) tmp[i] = f63_inv_sbox(tmp[i]);
    for (int i = 0; i < 14; i++)
        st[i] = f63_add(mds_row(mds, i, tmp), __ldg(ark + r * 28 + 14 + i));
}

// Sibling injection for one cluster pair (update/trace.rs:96-136).
__device__ void inject(u64* state, int base, const u64* sib, u64 bit) {
    for (int k = 0; k < 2; k++) {
        int reg = base + 15 * k;
        u64 digest[7];
        for (int i = 0; i < 7; i++) digest[i] = state[reg + i];
        for (int i = 0; i < 7; i++) {
            u64 s = __ldg(sib + i);
            state[reg + 7 + i] = bit ? digest[i] : s;
            state[reg + i] = bit ? s : digest[i];
        }
    }
    state[base + 14] = bit ? ONE_M : 0;
}

// Register map (models/transaction.py, models/merkle_update.py): clusters
// 0, 15, 29, 44 (+ bit registers 14, 43); PREV_ROOT 58; copies 65..92;
// Schnorr points 0..17 / 19..36 with bit registers 18 / 37, recomposition
// 38..41, hash state 42..55; delta range 56 / 57; sigma range 92 / 93.
__global__ void __launch_bounds__(THREADS)
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
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= T) return;
    const long long n = T * CYCLE;
    const int thl = 8 * depth + 7;
    u64 state[WIDTH], gen[12], pk[12], b3[6];
    for (int i = 0; i < WIDTH; i++) state[i] = init[t * WIDTH + i];
    for (int i = 0; i < 12; i++) gen[i] = __ldg(gen12 + i);
    for (int i = 0; i < 12; i++) pk[i] = pkey[t * 12 + i];
    for (int i = 0; i < 6; i++) b3[i] = __ldg(b3g + i);
    const u64* sib_s = sibs + t * 2 * depth * 7;
    const u64* sib_r = sib_s + depth * 7;
    const u64* bit_s = path_bits + t * 2 * depth;
    const u64* bit_r = bit_s + depth;
    const u64 *sb_t = sbits + t * 256, *hb_t = hbits + t * 256;
    const u64 *db_t = dbits + t * 64, *gb_t = gbits + t * 64;
    const long long col0 = t * CYCLE;

    for (int i = 0; i < WIDTH; i++) out[(long long)i * n + col0] = state[i];
    for (int step = 0; step < CYCLE - 1; step++) {
        if (step < 511) {
            if (step < thl) {
                const int cyc = step / 8, pos = step % 8;
                if (pos < 7) {
                    rescue_round(state + 0, pos, mds, ark);
                    rescue_round(state + 15, pos, mds, ark);
                    rescue_round(state + 29, pos, mds, ark);
                    rescue_round(state + 44, pos, mds, ark);
                } else {
                    inject(state, 0, sib_s + cyc * 7, bit_s[cyc]);
                    inject(state, 29, sib_r + cyc * 7, bit_r[cyc]);
                }
            }
            if (step == thl - 1)
                for (int i = 0; i < 7; i++) state[58 + i] = state[44 + i];
        } else if (step == 511) {
            for (int i = 0; i < 58; i++) state[i] = 0;
            state[6] = ONE_M;                       // y(S) = 1
            state[25] = ONE_M;                      // y(h.P) = 1
            for (int i = 0; i < 6; i++) state[42 + i] = rx[t * 6 + i];
            state[92] = 0;
            state[93] = 0;
        } else {
            const int sstep = step - 512;
            // hash lane: cols 42..56
            if (sstep < 40) {
                const int pos = sstep % 8;
                if (pos < 7)
                    rescue_round(state + 42, pos, mds, ark);
                else if (sstep < 32)
                    for (int i = 0; i < 7; i++)
                        state[49 + i] = msg[(t * 4 + sstep / 8) * 7 + i];
                else
                    for (int i = 0; i < 7; i++) state[49 + i] = 0;
            }
            // scalar-mul lane: cols 0..42
            if (sstep < 510) {
                const int real = sstep / 2;
                const int chunk = real < 63 ? 0 : (real - 63) / 64 + 1;
                const u64 sb = sb_t[254 - real], hb = hb_t[254 - real];
                state[18] = sb ? ONE_M : 0;
                state[37] = hb ? ONE_M : 0;
                u64 o[18];
                if ((sstep & 1) == 0) {
                    ec_double(state + 0, b3, o);
                    for (int i = 0; i < 18; i++) state[i] = o[i];
                    ec_double(state + 19, b3, o);
                    for (int i = 0; i < 18; i++) state[19 + i] = o[i];
                    const int vp = 41 - chunk;
                    state[vp] = f63_add(mdbl(state[vp]), state[37]);
                } else {
                    if (sb) {
                        ec_add_mixed(state + 0, gen, b3, o);
                        for (int i = 0; i < 18; i++) state[i] = o[i];
                    }
                    if (hb) {
                        ec_add_mixed(state + 19, pk, b3, o);
                        for (int i = 0; i < 18; i++) state[19 + i] = o[i];
                    }
                }
            } else if (sstep == 510) {
                u64 hp[18], o[18], zinv[6], xn[6];
                for (int i = 0; i < 18; i++) hp[i] = state[19 + i];
                state[18] = ONE_M;
                ec_add(state + 0, hp, b3, o);
                for (int i = 0; i < 18; i++) state[i] = o[i];
                f6inv(state + 12, zinv);
                f6mul(state + 0, zinv, xn);
                for (int i = 0; i < 6; i++) state[i] = xn[i];
            }
            // range lanes: cols 56/57 (delta), 92/93 (sigma)
            if (sstep < 64) {
                state[56] = db_t[63 - sstep] ? ONE_M : 0;
                state[57] = f63_add(mdbl(state[57]), state[56]);
                state[92] = gb_t[63 - sstep] ? ONE_M : 0;
                state[93] = f63_add(mdbl(state[93]), state[92]);
            }
        }
        const long long col = col0 + step + 1;
        for (int i = 0; i < WIDTH; i++) out[(long long)i * n + col] = state[i];
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
    long long blocks = (T + THREADS - 1) / THREADS;
    transaction_trace_kernel<<<(unsigned)blocks, THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const u64*)init, (const u64*)sibs, (const u64*)path_bits,
        (const u64*)pkey, (const u64*)rx, (const u64*)sbits,
        (const u64*)hbits, (const u64*)msg, (const u64*)dbits,
        (const u64*)gbits, (const u64*)gen12, (const u64*)b3,
        (const u64*)mds, (const u64*)ark, depth, T, (u64*)out);
    return (int)cudaGetLastError();
}
