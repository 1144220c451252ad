// Batched NTT / iNTT and coset low-degree extension over f63, natural order
// in and out, Montgomery values (R = 2^64), canonical outputs.
//
// Replaces certificate_stark_tpu/ops/ntt.py `ntt` / `intt` (:97, :311) and
// `lde` with its `coset_scale` (:326, :315), which the TPU runs as XLA
// radix-2 and four-step code (the Pallas `pallas_local_ntt` meant for it
// was deleted: Mosaic could not express its reshapes). The plain versions
// are ops/kernels.py `ntt_plain` and `lde_plain`; the launch plan is
// ops/kernels.py `ntt_plan`, whose index math and arithmetic
// tests/test_torch_ntt_plan.py replays on the CPU.
//
// The transform. n = n_0 n_1 ... n_{P-1} (one launch a pass). Write the
// input index i = sum_q i_q S_q with S_q = n_{q+1} ... n_{P-1} and the
// output index k = sum_q k_q T_q with T_q = n_0 ... n_{q-1}. Pass p takes
// the size-n_p DFT over i_p -> k_p with the other digits fixed, and
// multiplies by the twiddle w_n^(T_p k_p i''') with i''' = sum_{q>p} i_q S_q
// (the four-step identity, applied recursively). Between passes each
// digit sits at its output weight T_q: the first pass reads x at its
// natural positions and writes that layout, every later pass reads and
// writes the same positions (in place), and the last one leaves X in
// natural order. The inverse's 1/n rides on the first pass's twiddle
// table (ops/kernels.py `ntt_tables`), or, with one pass, is a multiply
// at its stores; a scale s (the composition's coset scale, fused) is a
// multiply by s^t at the last pass's stores.
//
// The LDE. Coefficients [C, n], blowup b, offset o -> out[c, r + b i] =
// NTT_n(coeffs[c, t] (o w_bn^r)^t)[i]: b size-n transforms of coset-scaled
// coefficients, with no padded copy. A block holds R = 2^log_R cosets
// r0 + rr, and (o w_bn^(r0 + rr))^t = (o w_bn^r0)^t (w_bn^t)^rr: a thread
// loads each coefficient of its unit once, takes the first factor once (a
// few multiplies a coefficient, shared by the R cosets) and runs the R
// cosets from it, each coset's values the previous coset's times w_bn^t.
// So the coset factor costs one multiply a point and a few a coefficient.
//
// A pass in a block. The block holds R x G columns (G adjacent groups of
// the strided side) of n_p points in shared memory, tile[idx][u] with u =
// g R + rr, in the bit-reversed order of radix-2 decimation in time. The
// log2 n_p stages run in rounds of k <= 4 (`ks`, from ntt_plan): a thread
// takes a unit of 2^k points of one column, the positions idx = hb 2^(s+k)
// + m 2^s + lo (m < 2^k), into registers and runs the round's k stages
// there (stage s + t pairs m and m + 2^t with the twiddle w_{n_p}^((m mod
// 2^t) 2^s + lo scaled to the stage), then writes them back. The first
// round loads straight from device memory (bit reversal is the choice of
// which points a unit loads) and the last stores straight to it, so a
// pass of 2^10 points takes two exchanges through shared memory and two
// barriers (one per stage before). The rounds' twiddles are one table of
// n_p - 1 entries in the order a warp reads them, staged in shared memory
// once a block; the first round's are the same for every unit (read from
// the table in device memory, and the multiplies by w^0 = 1 skipped). The
// tile's u64 slots are XOR-swizzled (sw_c, sw_sh, sw_mask) so that the
// first round's writes, whose lanes step along hb, and the later rounds'
// accesses, whose lanes step along u and lo, both take one wavefront a
// half-warp.
//
// The twiddles across passes, w_n^e with e < n. The LDE reads them from
// one table of n entries (8 MB at 2^20, held in L2; the R cosets of a warp
// read the same entry; copied to the card for each LDE, not kept there):
// one lookup and one multiply a point. The NTT,
// whose lanes read distinct entries, and the scale n^-1 s^t use tables
// split in two (w^e = lo[e mod 2^h] * hi[e >> h], at most 2^12 entries
// each, held in L1): a lookup pair and two multiplies a point.
//
// Bound on the H100: a pass reads and writes the array once (16 B a point;
// the LDE's first pass reads the coefficients once and writes b n points),
// so two passes move 8 C n (1 + 3 b) bytes; the operations are a
// Montgomery multiply a butterfly plus the twiddles: at [94, 2^20] ->
// 2^23 chip_smoke.py `_ntt_cost` counts 11 a point (bound by operations,
// with the two-pass traffic close behind). A butterfly takes ~36 integer
// instructions (the multiply ~21 of them) and issues at the integer rate,
// so the design counts instructions: lazy outputs (`dit`), per-unit index
// math in 32 bits (positions within a column need log2(b n) <= 31), and
// the tile's slots by XOR (`Bits`).
#include <cuda_runtime.h>

#include "f63.cuh"

#define NTT_THREADS 256
#define NTT_TILE_LOG 13       // points a block, log2 (ops/kernels.py NTT_TILE)
#define NTT_MAX_PASSES 32
#define NTT_MAX_ROUNDS 4      // rounds a pass (ops/kernels.py: same names)
#define NTT_KMAX 4            // stages a round, at most
#define NTT_LDE_K0 2          // stages of the LDE's first round, at most

struct NttArgs {
    const u64* src;
    u64* dst;
    const u64* rtw;                // the pass's round twiddles, n_p - 1
    const u64* tw_lo;              // ntt: w_n^e = tw_lo[e mod 2^h_tw] *
    const u64* tw_hi;              //   tw_hi[e >> h_tw]; lde: w_bn^e
    const u64* tw_n;               // lde: w_n^e, e < n (else null)
    const u64* s_lo;               // LDE: o^t; scale 2: s^t (split at
    const u64* s_hi;               // h_s; times n^-1 where one pass)
    u64 ninv;                      // Montgomery 1/n (scale 1)
    long long C;
    int log_n, log_b, P, p, log_R, log_G, h_tw, h_s, scale;
    int nr, sw_c, sw_sh, sw_mask;  // rounds; the tile's swizzle
    int ks[NTT_MAX_ROUNDS];        // log2 of each round's unit
    int lg[NTT_MAX_PASSES];        // log2 n_q
};

// What a block works on, decoded once.
struct Blk {
    const u64* src;                // the column's input
    u64* dst;                      // the column's output
    u32 r0, j0, K0, H, i3;
    int lp, lgT, lgS, log_RG;
};

// The butterflies' arithmetic. A canonical value is < p; a lazy one is
// < 3p (< 2^64), congruent, and only ever multiplied. a + b - p and a - b
// of canonical a, b lie in [-p, p) (p < 2^63), so one signed test picks
// the representative.
__device__ __forceinline__ u64 add_p(u64 a, u64 b) {
    long long s = (long long)(a + b - F63_P);
    if (s < 0) s += (long long)F63_P;
    return (u64)s;
}

__device__ __forceinline__ u64 sub_p(u64 a, u64 b) {
    long long d = (long long)(a - b);
    if (d < 0) d += (long long)F63_P;
    return (u64)d;
}

// REDC(a * b) without the final subtraction, for any a < 3p and b < p:
// a b < p 2^64, so f63_redc's two steps leave (a b + M p) / 2^64 <
// p (1 + 3p / 2^64) < 1.77 p.
__device__ __forceinline__ u64 mmul_lazy(u64 a, u64 b) {
    u32 t0, t1, t2, t3;
    f63_mul_wide(a, b, t0, t1, t2, t3);
    u32 z, m = 0u - t0;
    asm("add.cc.u32      %0, %4, %5;\n\t"
        "madc.lo.cc.u32  %1, %5, %6, %1;\n\t"
        "madc.hi.cc.u32  %2, %5, %6, %2;\n\t"
        "addc.u32        %3, %3, 0;"
        : "=&r"(z), "+r"(t1), "+r"(t2), "+r"(t3)
        : "r"(t0), "r"(m), "r"(F63_K));
    m = 0u - t1;
    asm("add.cc.u32      %0, %3, %4;\n\t"
        "madc.lo.cc.u32  %1, %4, %5, %1;\n\t"
        "madc.hi.u32     %2, %4, %5, %2;"
        : "=&r"(z), "+r"(t2), "+r"(t3)
        : "r"(t1), "r"(m), "r"(F63_K));
    return join32(t2, t3);
}

// REDC(a * b), canonical, for any a < 3p and b < p.
__device__ __forceinline__ u64 mmul(u64 a, u64 b) {
    long long s = (long long)(mmul_lazy(a, b) - F63_P);   // in [-p, p)
    if (s < 0) s += (long long)F63_P;
    return (u64)s;
}

__device__ __forceinline__ u64 split_pow(const u64* lo, const u64* hi, int h,
                                         u32 e) {
    return mmul(__ldg(lo + (e & ((1u << h) - 1))), __ldg(hi + (e >> h)));
}

__device__ __forceinline__ u32 brev(u32 x, int bits) {
    return bits ? __brev(x) >> (32 - bits) : 0u;
}

// brev of a register index, at compile time
__host__ __device__ constexpr u32 brev_c(int m, int bits) {
    u32 r = 0;
    for (int i = 0; i < bits; i++) r |= (u32)((m >> i) & 1) << (bits - 1 - i);
    return r;
}

// The tile's swizzle of slot s = idx 2^log_RG + u. It is XOR-linear, so
// a unit's slot of register m is swz(its base) ^ swz(m << q), and the
// latter the XOR of the set bits' swz(1 << (q + i)), uniform in a round.
__device__ __forceinline__ u32 swz(const NttArgs& a, u32 s) {
    return s ^ (((s >> a.sw_c) & (u32)a.sw_mask) << a.sw_sh);
}

template <int K>
struct Bits {
    u32 b[K > 0 ? K : 1];
    __device__ __forceinline__ Bits(const NttArgs& a, int q) {
#pragma unroll
        for (int i = 0; i < K; i++) b[i] = swz(a, 1u << (q + i));
    }
    __device__ __forceinline__ u32 operator()(int m) const {
        u32 r = 0;
#pragma unroll
        for (int i = 0; i < K; i++)
            if ((m >> i) & 1) r ^= b[i];
        return r;
    }
};

// K radix-2 stages s .. s + K - 1 on a unit's 2^K points. FIRST: the
// first round (s = 0, lo = 0), its twiddles w[2^t - 1 + ml] from device
// memory and w^0 = 1 not multiplied; else w from the staged table. The
// x of a butterfly is canonical. An output stays lazy (x + y, or x + 2p -
// y) where the next stage only multiplies it: the y of stage t + 1 (bit
// t + 1 set), except in the first round where ml of stage t + 1 is 0 (its
// twiddle is 1 and not multiplied), and after the last stage where
// LAZY_OUT (the store multiplies every output). A multiply both of whose
// outputs stay lazy skips its final subtraction.
template <int K, bool FIRST, bool LAZY_OUT>
__device__ __forceinline__ void dit(u64* v, const u64* w, int s, u32 lo) {
#pragma unroll
    for (int t = 0; t < K; t++) {
#pragma unroll
        for (int m = 0; m < (1 << K); m++) {
            if (m & (1 << t)) continue;
            const int ml = m & ((1 << t) - 1), mh = m | (1 << t);
            const bool next_y = t + 1 < K ? (m >> (t + 1)) & 1 : LAZY_OUT;
            const bool lazy_x = next_y && (t + 1 == K || !FIRST || ml != 0);
            const bool lazy_y = next_y;
            u64 y = v[mh];
            if (!FIRST || ml) {
                const u64 wv = FIRST ? __ldg(w + (1 << t) - 1 + ml)
                                     : w[(((1 << t) - 1 + ml) << s) + lo];
                y = lazy_x ? mmul_lazy(y, wv) : mmul(y, wv);
            }
            const u64 x = v[m];
            v[m] = lazy_x ? x + y : add_p(x, y);
            v[mh] = lazy_y ? x + 2 * F63_P - y : sub_p(x, y);
        }
    }
}

// The pass's outputs k_m = m 2^s + lo of column u, from registers, with
// the twiddle w_n^e (not the last pass; the LDE's from the direct table)
// or the inverse's scale (the last); the values are lazy where
// `lazy_store` (a multiply follows), else canonical.
__device__ __forceinline__ bool lazy_store(const NttArgs& a) {
    return a.p != a.P - 1 || a.scale != 0;
}

template <int K>
__device__ __forceinline__ void store(const NttArgs& a, const Blk& B,
                                      const u64* v, u32 u, int s, u32 lo) {
    const u32 rr = u & ((1u << a.log_R) - 1), g = u >> a.log_R;
    const int lp = B.lp;
    u32 pos, step, e, estep;
    if (a.p == 0) {
        // j's digits i_1 .. i_{P-1} (S weights) at their output weights
        const u32 j = B.j0 + g;
        u32 Hj = 0, rest = j;
        int sh = a.log_n - lp;
        for (int q = a.P - 1; q >= 1; q--) {
            sh -= a.lg[q];
            Hj |= (rest & ((1u << a.lg[q]) - 1)) << sh;
            rest >>= a.lg[q];
        }
        pos = B.r0 + rr + ((lo + (Hj << lp)) << a.log_b);
        step = 1u << (s + a.log_b);
        e = j * lo;                               // w_n^(j k)
        estep = j << s;
    } else {
        pos = B.r0 + rr + ((B.K0 + g + (lo << B.lgT) + (B.H << (B.lgT + lp)))
                           << a.log_b);
        step = 1u << (s + B.lgT + a.log_b);
        e = (B.i3 * lo) << B.lgT;                 // w_n^((i''' k) T_p)
        estep = B.i3 << (s + B.lgT);
    }
    u64* out = B.dst + pos;
    if (a.p != a.P - 1) {
        if (a.tw_n) {
#pragma unroll
            for (int m = 0; m < (1 << K); m++)
                out[m * step] = mmul(v[m], __ldg(a.tw_n + e + m * estep));
        } else {
#pragma unroll
            for (int m = 0; m < (1 << K); m++)
                out[m * step] = mmul(v[m], split_pow(a.tw_lo, a.tw_hi, a.h_tw,
                                                     e + m * estep));
        }
    } else if (a.scale == 1) {
#pragma unroll
        for (int m = 0; m < (1 << K); m++) out[m * step] = mmul(v[m], a.ninv);
    } else if (a.scale == 2) {                    // t = pos (b = 1)
#pragma unroll
        for (int m = 0; m < (1 << K); m++)
            out[m * step] = mmul(v[m], split_pow(a.s_lo, a.s_hi, a.h_s,
                                                 pos + m * step));
    } else {
#pragma unroll
        for (int m = 0; m < (1 << K); m++) out[m * step] = v[m];
    }
}

// The first round: units (u, hb) load the points d = brev(idx) of idx =
// hb 2^K + m straight from device memory.
template <int K>
__device__ __forceinline__ void round0(const NttArgs& a, const Blk& B,
                                       u64* tile) {
    const int lh = B.lp - K;                      // hb's bits
    const u32 units = 1u << (B.log_RG + lh);
    const Bits<K> ms(a, B.log_RG);
    for (u32 e = threadIdx.x; e < units; e += blockDim.x) {
        const u32 u = e & ((1u << B.log_RG) - 1), hb = e >> B.log_RG;
        const u32 rr = u & ((1u << a.log_R) - 1), g = u >> a.log_R;
        const u32 dh = brev(hb, lh);
        u32 base, dstep;
        if (a.p == 0) {
            base = (dh << B.lgS) + B.j0 + g;
            dstep = 1u << (lh + B.lgS);
        } else {
            base = B.r0 + rr + ((B.K0 + g + (dh << B.lgT)
                                 + (B.H << (B.lgT + B.lp))) << a.log_b);
            dstep = 1u << (lh + B.lgT + a.log_b);
        }
        u64 v[1 << K];
#pragma unroll
        for (int m = 0; m < (1 << K); m++)
            v[m] = B.src[base + brev_c(m, K) * dstep];
        if (a.nr == 1) {
            if (lazy_store(a)) dit<K, true, true>(v, a.rtw, 0, 0);
            else dit<K, true, false>(v, a.rtw, 0, 0);
            store<K>(a, B, v, u, 0, 0);
        } else {
            dit<K, true, false>(v, a.rtw, 0, 0);
            const u32 base = swz(a, (hb << (K + B.log_RG)) | u);
#pragma unroll
            for (int m = 0; m < (1 << K); m++) tile[base ^ ms(m)] = v[m];
        }
    }
}

// The LDE's first round: units (hb, g) load their 2^K coefficients once,
// scale them by (o w_bn^r0)^t, and run the R cosets from them, each
// coset's values the previous coset's times w_bn^t.
template <int K>
__device__ __forceinline__ void round0_lde(const NttArgs& a, const Blk& B,
                                           u64* tile) {
    const int lh = B.lp - K;
    const u32 R = 1u << a.log_R;
    const u32 units = 1u << (a.log_G + lh);
    const Bits<K> ms(a, B.log_RG);
    for (u32 e = threadIdx.x; e < units; e += blockDim.x) {
        const u32 hb = e & ((1u << lh) - 1), g = e >> lh;
        const u32 t0 = (brev(hb, lh) << B.lgS) + B.j0 + g;
        const u32 tstep = 1u << (lh + B.lgS);
        u64 y[1 << K], z[1 << K];
#pragma unroll
        for (int m = 0; m < (1 << K); m++) {
            const u32 t = t0 + brev_c(m, K) * tstep;
            y[m] = mmul(__ldg(B.src + t), split_pow(a.s_lo, a.s_hi, a.h_s, t));
            if (B.r0)
                y[m] = mmul(y[m], split_pow(a.tw_lo, a.tw_hi, a.h_tw,
                                            B.r0 * t));
            if (R > 1) z[m] = split_pow(a.tw_lo, a.tw_hi, a.h_tw, t);
        }
        const u32 base = swz(a, (hb << (K + B.log_RG)) | (g << a.log_R));
        for (u32 rr = 0; rr < R; rr++) {
            u64 v[1 << K];
#pragma unroll
            for (int m = 0; m < (1 << K); m++) v[m] = y[m];
            if (a.nr == 1) {
                if (lazy_store(a)) dit<K, true, true>(v, a.rtw, 0, 0);
                else dit<K, true, false>(v, a.rtw, 0, 0);
                store<K>(a, B, v, (g << a.log_R) | rr, 0, 0);
            } else {
                dit<K, true, false>(v, a.rtw, 0, 0);
                const u32 br = base ^ swz(a, rr);
#pragma unroll
                for (int m = 0; m < (1 << K); m++) tile[br ^ ms(m)] = v[m];
            }
            if (rr + 1 < R) {
#pragma unroll
                for (int m = 0; m < (1 << K); m++) y[m] = mmul(y[m], z[m]);
            }
        }
    }
}

// A later round: stages s .. s + K - 1 on units (u, lo, hb) from the tile,
// back to the tile or, the last, to device memory.
template <int K>
__device__ __forceinline__ void round_n(const NttArgs& a, const Blk& B,
                                        u64* tile, const u64* rt, int s,
                                        bool last) {
    const u32 units = 1u << (B.log_RG + B.lp - K);
    const Bits<K> ms(a, s + B.log_RG);
    for (u32 e = threadIdx.x; e < units; e += blockDim.x) {
        const u32 u = e & ((1u << B.log_RG) - 1), q = e >> B.log_RG;
        const u32 lo = q & ((1u << s) - 1), hb = q >> s;
        const u32 base = swz(a, (((hb << (s + K)) | lo) << B.log_RG) | u);
        u64 v[1 << K];
#pragma unroll
        for (int m = 0; m < (1 << K); m++) v[m] = tile[base ^ ms(m)];
        if (last) {
            if (lazy_store(a)) dit<K, false, true>(v, rt, s, lo);
            else dit<K, false, false>(v, rt, s, lo);
            store<K>(a, B, v, u, s, lo);
        } else {
            dit<K, false, false>(v, rt, s, lo);
#pragma unroll
            for (int m = 0; m < (1 << K); m++) tile[base ^ ms(m)] = v[m];
        }
    }
}

// MINB blocks an SM: 3 (at most 80 registers, some spilled) for the
// LDE's first pass, whose coset loop gains from the warps; 2 (126
// registers, none spilled) for the passes of register rounds alone.
template <bool LDE, int MINB>
__global__ void __launch_bounds__(NTT_THREADS, MINB)
ntt_pass_kernel(const NttArgs a) {
    extern __shared__ u64 smem[];
    Blk B;
    const int p = a.p;
    B.lp = a.lg[p];
    B.lgT = 0;
    for (int q = 0; q < p; q++) B.lgT += a.lg[q];
    B.lgS = a.log_n - B.lgT - B.lp;
    B.log_RG = a.log_R + a.log_G;

    // the block: its cosets r0 + [0, R), then its group and fixed digits
    u32 blk = blockIdx.x;
    B.r0 = (blk & ((1u << (a.log_b - a.log_R)) - 1)) << a.log_R;
    blk >>= a.log_b - a.log_R;
    B.j0 = B.K0 = B.H = B.i3 = 0;
    u32 c;
    if (p == 0) {        // G adjacent j of [0, S_0)
        const int lgj = B.lgS - a.log_G;
        B.j0 = (blk & ((1u << lgj) - 1)) << a.log_G;
        c = blk >> lgj;
    } else {             // G adjacent low digits K, then the high digits H
        const int lgk = B.lgT - a.log_G;
        B.K0 = (blk & ((1u << lgk) - 1)) << a.log_G;
        blk >>= lgk;
        B.H = blk & ((1u << B.lgS) - 1);
        c = blk >> B.lgS;
        // i''' of the block: H's digits (i_{p+1} lowest) at S weights
        u32 rest = B.H;
        int sw = B.lgS;
        for (int q = p + 1; q < a.P; q++) {
            sw -= a.lg[q];
            B.i3 |= (rest & ((1u << a.lg[q]) - 1)) << sw;
            rest >>= a.lg[q];
        }
    }
    const unsigned long long col = 1ull << (a.log_b + a.log_n);
    B.src = a.src + (unsigned long long)c * (p == 0 ? 1ull << a.log_n : col);
    B.dst = a.dst + (unsigned long long)c * col;

    u64* rt = smem;                                // n_p - 1 twiddles
    u64* tile = smem + (1 << B.lp);
    if (a.nr > 1)       // read after the first barrier
        for (int i = threadIdx.x; i < (1 << B.lp) - 1; i += blockDim.x)
            rt[i] = __ldg(a.rtw + i);

    if (LDE && p == 0) {
        switch (a.ks[0]) {
            case 0: round0_lde<0>(a, B, tile); break;
            case 1: round0_lde<1>(a, B, tile); break;
            default: round0_lde<2>(a, B, tile); break;
        }
    } else {
        switch (a.ks[0]) {
            case 0: round0<0>(a, B, tile); break;
            case 1: round0<1>(a, B, tile); break;
            case 2: round0<2>(a, B, tile); break;
            case 3: round0<3>(a, B, tile); break;
            default: round0<4>(a, B, tile); break;
        }
    }
    int s = a.ks[0], off = (1 << a.ks[0]) - 1;
    for (int rho = 1; rho < a.nr; rho++) {
        __syncthreads();
        const int k = a.ks[rho];
        const bool last = rho == a.nr - 1;
        switch (k) {
            case 1: round_n<1>(a, B, tile, rt + off, s, last); break;
            case 2: round_n<2>(a, B, tile, rt + off, s, last); break;
            case 3: round_n<3>(a, B, tile, rt + off, s, last); break;
            default: round_n<4>(a, B, tile, rt + off, s, last); break;
        }
        off += ((1 << k) - 1) << s;
        s += k;
    }
}

template <bool LDE, int MINB>
static int launch_kernel(const NttArgs& a, unsigned blocks, size_t smem,
                         cudaStream_t stream) {
    static bool attr = false;   // once an instantiation: above 48 KB
    if (!attr) {
        cudaError_t e = cudaFuncSetAttribute(
            ntt_pass_kernel<LDE, MINB>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(sizeof(u64) << (NTT_TILE_LOG + 1)));
        if (e != cudaSuccess) return (int)e;
        attr = true;
    }
    ntt_pass_kernel<LDE, MINB><<<blocks, NTT_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool LDE>
static int launch_pass(const NttArgs& a, cudaStream_t stream) {
    if (a.C <= 0) return 0;
    if (a.P < 1 || a.P > NTT_MAX_PASSES || a.p < 0 || a.p >= a.P)
        return (int)cudaErrorInvalidValue;
    int sum = 0, lgT = 0;
    for (int q = 0; q < a.P; q++) {
        if (a.lg[q] < 0) return (int)cudaErrorInvalidValue;
        sum += a.lg[q];
        if (q < a.p) lgT += a.lg[q];
    }
    const int lp = a.lg[a.p], log_pts = a.log_R + a.log_G + lp;
    const int avail = a.p == 0 ? a.log_n - lp : lgT;   // log2 of G's axis
    if (sum != a.log_n || a.log_R < 0 || a.log_R > a.log_b || a.log_G < 0 ||
        a.log_G > avail || log_pts > NTT_TILE_LOG || a.log_n + a.log_b > 31)
        return (int)cudaErrorInvalidValue;
    // the rounds: 1 .. NTT_MAX_ROUNDS of 1 .. NTT_KMAX stages summing to
    // log2 n_p (one of 0 where n_p = 1); the LDE's first at most NTT_LDE_K0
    int ksum = 0;
    if (a.nr < 1 || a.nr > NTT_MAX_ROUNDS) return (int)cudaErrorInvalidValue;
    for (int r = 0; r < a.nr; r++) {
        if (a.ks[r] < (lp > 0) || a.ks[r] > NTT_KMAX)
            return (int)cudaErrorInvalidValue;
        ksum += a.ks[r];
    }
    if (ksum != lp || (LDE && a.p == 0 && a.ks[0] > NTT_LDE_K0) ||
        LDE != (a.tw_n != nullptr) ||
        (LDE && a.scale != 0) || a.scale < 0 || a.scale > 2 ||
        a.sw_c < 1 || a.sw_sh < 0 || a.sw_mask < 0 || a.sw_mask > 15)
        return (int)cudaErrorInvalidValue;
    const long long blocks = a.C << (a.log_b + a.log_n - log_pts);
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(u64) * ((1u << lp) + (1u << log_pts));
    if constexpr (LDE)
        if (a.p == 0)
            return launch_kernel<true, 3>(a, (unsigned)blocks, smem, stream);
    return launch_kernel<LDE, 2>(a, (unsigned)blocks, smem, stream);
}

// desc: log_R, log_G, the number of rounds, their 4 log2 sizes, sw_c,
// sw_sh, sw_mask (ops/kernels.py `_pass_desc`)
static int fill(NttArgs& a, const int* lg, int P, int p, const int* desc) {
    if (P < 1 || P > NTT_MAX_PASSES) return 0;
    a.P = P;
    a.p = p;
    for (int q = 0; q < P; q++) a.lg[q] = lg[q];
    a.log_R = desc[0];
    a.log_G = desc[1];
    a.nr = desc[2];
    for (int r = 0; r < NTT_MAX_ROUNDS; r++) a.ks[r] = desc[3 + r];
    a.sw_c = desc[3 + NTT_MAX_ROUNDS];
    a.sw_sh = desc[4 + NTT_MAX_ROUNDS];
    a.sw_mask = desc[5 + NTT_MAX_ROUNDS];
    return 1;
}

// One pass p of the NTT of [C, 2^log_n] (src -> dst; dst may be src for
// p > 0): lg[0..P) the passes' log2 sizes, desc the pass's layout, rtw
// its round twiddles, tw_lo / tw_hi the split w_n^e (inverse roots for the
// inverse); scale 1: multiply by ninv (Montgomery) at the last pass's
// stores, 2: by s_lo[t mod 2^h_s] * s_hi[t >> h_s] (n^-1 s^t).
extern "C" int ntt_launch(const void* src, void* dst, long long C, int log_n,
                          const int* lg, int P, int p, const int* desc,
                          const void* rtw, const void* tw_lo,
                          const void* tw_hi, int h_tw, const void* s_lo,
                          const void* s_hi, int h_s, long long ninv,
                          int scale, void* stream) {
    NttArgs a = {};
    if (!fill(a, lg, P, p, desc)) return (int)cudaErrorInvalidValue;
    a.src = (const u64*)src; a.dst = (u64*)dst; a.rtw = (const u64*)rtw;
    a.tw_lo = (const u64*)tw_lo; a.tw_hi = (const u64*)tw_hi;
    a.s_lo = (const u64*)s_lo; a.s_hi = (const u64*)s_hi;
    a.C = C; a.log_n = log_n; a.log_b = 0; a.h_tw = h_tw; a.h_s = h_s;
    a.scale = scale; a.ninv = (u64)ninv;
    return launch_pass<false>(a, (cudaStream_t)stream);
}

// One pass p of the LDE of coefficients [C, 2^log_n] into [C, 2^(log_b +
// log_n)] over o <w_bn>: tw_n the w_n^e (e < n) of the stores' twiddles,
// tw_lo / tw_hi the split w_bn^e (e < b n) and o_lo / o_hi the split o^t
// (t < n) of the first pass's coset factor.
extern "C" int lde_launch(const void* src, void* dst, long long C, int log_n,
                          int log_b, const int* lg, int P, int p,
                          const int* desc, const void* rtw, const void* tw_n,
                          const void* tw_lo, const void* tw_hi, int h_tw,
                          const void* o_lo, const void* o_hi, int h_o,
                          void* stream) {
    NttArgs a = {};
    if (!fill(a, lg, P, p, desc)) return (int)cudaErrorInvalidValue;
    a.src = (const u64*)src; a.dst = (u64*)dst; a.rtw = (const u64*)rtw;
    a.tw_lo = (const u64*)tw_lo; a.tw_hi = (const u64*)tw_hi;
    a.tw_n = (const u64*)tw_n;
    a.s_lo = (const u64*)o_lo; a.s_hi = (const u64*)o_hi;
    a.C = C; a.log_n = log_n; a.log_b = log_b; a.h_tw = h_tw; a.h_s = h_o;
    a.scale = 0;
    return launch_pass<true>(a, (cudaStream_t)stream);
}
