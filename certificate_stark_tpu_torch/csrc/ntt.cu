// Batched NTT / iNTT and coset low-degree extension over f63, natural order
// in and out, Montgomery values (R = 2^64), canonical outputs.
//
// Replaces certificate_stark_tpu/ops/ntt.py `ntt` / `intt` (:97, :311) and
// `lde` with its `coset_scale` (:326, :315), which the TPU runs as XLA
// radix-2 and four-step code (the Pallas `pallas_local_ntt` meant for it
// was deleted: Mosaic could not express its reshapes). The template is
// native/ntt.c `f63_ntt_batch` (:107): radix-2 decimation in time on a
// bit-reversed copy. The plain versions are ops/kernels.py `ntt_plain` and
// `lde_plain`; the launch plan is ops/kernels.py `ntt_plan`, whose index
// math tests/test_torch_ntt_plan.py replays on the CPU.
//
// The transform. n = n_0 n_1 ... n_{P-1} (one launch a pass). Write the
// input index i = sum_q i_q S_q with S_q = n_{q+1} ... n_{P-1} and the
// output index k = sum_q k_q T_q with T_q = n_0 ... n_{q-1}. Pass p takes
// the size-n_p DFT over i_p -> k_p with the other digits fixed, and
// multiplies by the twiddle w_n^(T_p k_p i''') with i''' = sum_{q>p} i_q S_q
// (the four-step identity X[k_0 + n_0 k'] = DFT_{n/n_0}(w_n^(i' k_0)
// DFT_{n_0}(x[. S_0 + i'])[k_0])[k'], applied recursively). Between passes
// each digit, transformed or not, sits at its output weight T_q: the first
// pass reads x at its natural positions and writes that layout, every later
// pass reads and writes the same positions (in place), and the last one
// leaves X in natural order. So no scratch buffer and no digit reversal
// pass; the inverse multiplies by 1/n at the last pass's stores.
//
// The LDE. Coefficients [C, n], blowup b, offset o -> out[c, r + b i] =
// NTT_n(coeffs[c, t] (o w_bn^r)^t)[i]: b size-n transforms of coset-scaled
// coefficients, with no padded copy. The factor o^t w_bn^(r t) is applied
// at the first pass's load, each coefficient read once for the R cosets of
// a block, and the stride-b interleave is the position map r + b idx of
// every pass, so blocks holding all b cosets store runs of b values.
//
// A block holds R cosets x G groups x n_p points in dynamic shared memory
// (at most NTT_TILE_LOG: 2^13 points, 64 KB, so 2^24 points take two
// passes of at most 2^12), loads them bit reversed, runs log2 n_p radix-2
// stages and stores with the twiddle. The G groups are adjacent columns of
// the strided side: adjacent j = i''' at the first pass's loads, adjacent
// low digits sum_{q<p} k_q T_q at a later pass's loads and stores.
// Twiddles come from small tables: each pass's w_{n_p}^k (k < n_p/2), and
// w_n^e, o^t, w_bn^e split in two (lo[e mod 2^h] * hi[e >> h], one more
// multiply) so that no table is larger than 2^12 entries.
//
// Bound on the H100: a pass reads and writes the array once (16 B a point;
// the LDE's first pass reads the coefficients once and writes b n points),
// and does log2(n_p)/2 multiplies a point in its butterflies, two a point
// for the twiddle, four a point of the LDE's coset factor. At [94, 2^20]
// -> 2^23 that is ~8.7e9 Montgomery multiplies: bound by operations
// (chip_smoke.py `_ntt_cost` counts one a butterfly, a coset factor and a
// 1/n). The design keeps each pass to one read and one write of the array
// and gives the strided side G adjacent columns; it is a first version:
// radix-2 stages in shared memory, a barrier between stages.
#include <cuda_runtime.h>

#include "f63.cuh"

#define NTT_THREADS 256
#define NTT_TILE_LOG 13       // points a block, log2 (ops/kernels.py NTT_TILE)
#define NTT_MAX_PASSES 32

struct NttArgs {
    const u64* src;
    u64* dst;
    const u64* stage;              // w_{n_p}^k, k < n_p / 2
    const u64* tw_lo;              // w_n^e = tw_lo[e mod 2^h_tw] *
    const u64* tw_hi;              //         tw_hi[e >> h_tw]
    const u64* o_lo;               // LDE: o^t, split at h_o
    const u64* o_hi;
    const u64* c_lo;               // LDE: w_bn^e, split at h_c
    const u64* c_hi;
    long long C;
    int log_n, log_b, P, p, log_R, log_G, h_tw, h_o, h_c, scale;
    u64 ninv;                      // Montgomery 1/n, applied where scale
    int lg[NTT_MAX_PASSES];        // log2 n_q
};

__device__ __forceinline__ u64 f63_sub(u64 a, u64 b) {
    return a >= b ? a - b : a + (F63_P - b);
}

__device__ __forceinline__ u64 split_pow(const u64* lo, const u64* hi, int h,
                                         unsigned long long e) {
    return f63_mmul(__ldg(lo + (e & ((1ull << h) - 1))), __ldg(hi + (e >> h)));
}

__device__ __forceinline__ unsigned brev(unsigned x, int bits) {
    return bits ? __brev(x) >> (32 - bits) : 0u;
}

template <bool LDE>
__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const NttArgs a) {
    extern __shared__ u64 tile[];
    const int p = a.p, lp = a.lg[p];
    int lgT = 0;                                   // log2 T_p
    for (int q = 0; q < p; q++) lgT += a.lg[q];
    const int lgS = a.log_n - lgT - lp;            // log2 S_p
    const int R = 1 << a.log_R, G = 1 << a.log_G, RG = R * G;
    const int log_RG = a.log_R + a.log_G;
    const int pts = RG << lp;
    const long long b = 1ll << a.log_b;
    const long long col = b << a.log_n;            // output points a column
    const int tid = threadIdx.x, nth = blockDim.x;

    // the block: its cosets r0 + [0, R), then its group and fixed digits
    unsigned long long blk = blockIdx.x;
    const long long r0 = (long long)(blk & ((b >> a.log_R) - 1)) << a.log_R;
    blk >>= a.log_b - a.log_R;
    long long c, j0 = 0, K0 = 0, H = 0;
    if (p == 0) {        // G adjacent j of [0, S_0)
        const int lgj = lgS - a.log_G;
        j0 = (long long)(blk & ((1ull << lgj) - 1)) << a.log_G;
        c = (long long)(blk >> lgj);
    } else {             // G adjacent low digits K, then the high digits H
        const int lgk = lgT - a.log_G;
        K0 = (long long)(blk & ((1ull << lgk) - 1)) << a.log_G;
        blk >>= lgk;
        H = (long long)(blk & ((1ull << lgS) - 1));
        c = (long long)(blk >> lgS);
    }
    const u64* src = a.src + c * (p == 0 ? (1ll << a.log_n) : col);
    u64* dst = a.dst + c * col;

    // ---- load, bit reversed along the transform axis
    if (p == 0) {
        for (int e = tid; e < pts; e += nth) {
            const int r = e & (R - 1), g = (e >> a.log_R) & (G - 1);
            const int i0 = e >> log_RG;
            const long long t = ((long long)i0 << lgS) + j0 + g;
            u64 v = src[t];
            if (LDE) {   // (o w_bn^r)^t = o^t w_bn^(r t), r t < b n
                v = f63_mmul(v, split_pow(a.o_lo, a.o_hi, a.h_o, t));
                v = f63_mmul(v, split_pow(a.c_lo, a.c_hi, a.h_c,
                                          (unsigned long long)(r0 + r) * t));
            }
            tile[(((long long)brev(i0, lp) << a.log_G) + g) * R + r] = v;
        }
    } else {
        for (int e = tid; e < pts; e += nth) {
            const int r = e & (R - 1), g = (e >> a.log_R) & (G - 1);
            const int d = e >> log_RG;
            const long long pos = r0 + r + b * (K0 + g + ((long long)d << lgT)
                                                + (H << (lgT + lp)));
            tile[(((long long)brev(d, lp) << a.log_G) + g) * R + r] = src[pos];
        }
    }
    __syncthreads();

    // ---- log2 n_p radix-2 stages, natural order out
    const int half = pts >> 1;
    for (int s = 0; s < lp; s++) {
        for (int bf = tid; bf < half; bf += nth) {
            const int u = bf & (RG - 1), jj = bf >> log_RG;
            const int pos = jj & ((1 << s) - 1);
            const int lo = ((jj >> s) << (s + 1)) + pos;
            const u64 w = __ldg(a.stage + (pos << (lp - 1 - s)));
            const int il = lo * RG + u, ih = (lo + (1 << s)) * RG + u;
            const u64 x = tile[il], y = f63_mmul(tile[ih], w);
            tile[il] = f63_add(x, y);
            tile[ih] = f63_sub(x, y);
        }
        __syncthreads();
    }

    // ---- store, with the twiddle w_n^(T_p k_p i''') and 1/n where asked
    const bool last = p == a.P - 1;
    if (p == 0) {
        // the G columns' digits i_1 .. i_{P-1} (S weights in j) at their
        // output weights T_q / T_1
        for (int e = tid; e < pts; e += nth) {
            const int r = e & (R - 1);
            const int k = (e >> a.log_R) & ((1 << lp) - 1);
            const int g = e >> (a.log_R + lp);
            const long long j = j0 + g;
            long long Hj = 0, rest = j;
            int tot = a.log_n - lp, suf = 0;
            for (int q = a.P - 1; q >= 1; q--) {
                suf += a.lg[q];
                Hj |= (rest & ((1ll << a.lg[q]) - 1)) << (tot - suf);
                rest >>= a.lg[q];
            }
            u64 v = tile[(((long long)k << a.log_G) + g) * R + r];
            if (!last)
                v = f63_mmul(v, split_pow(a.tw_lo, a.tw_hi, a.h_tw,
                                          (unsigned long long)j * k));
            if (a.scale) v = f63_mmul(v, a.ninv);
            dst[r0 + r + b * (k + (Hj << lp))] = v;
        }
    } else {
        // i''' of the block: H's digits (i_{p+1} lowest) at S weights
        unsigned long long i3 = 0, rest = H;
        int sw = lgS;
        for (int q = p + 1; q < a.P; q++) {
            sw -= a.lg[q];
            i3 |= (rest & ((1ull << a.lg[q]) - 1)) << sw;
            rest >>= a.lg[q];
        }
        for (int e = tid; e < pts; e += nth) {
            const int r = e & (R - 1), g = (e >> a.log_R) & (G - 1);
            const int k = e >> log_RG;
            u64 v = tile[(((long long)k << a.log_G) + g) * R + r];
            if (!last)
                v = f63_mmul(v, split_pow(a.tw_lo, a.tw_hi, a.h_tw,
                                          (i3 * k) << lgT));
            if (a.scale) v = f63_mmul(v, a.ninv);
            dst[r0 + r + b * (K0 + g + ((long long)k << lgT)
                              + (H << (lgT + lp)))] = v;
        }
    }
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
        a.log_G > avail || log_pts > NTT_TILE_LOG || a.log_n + a.log_b > 40)
        return (int)cudaErrorInvalidValue;
    const long long blocks = a.C << (a.log_b + a.log_n - log_pts);
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    static bool attr = false;   // once an instantiation: above 48 KB
    if (!attr) {
        cudaError_t e = cudaFuncSetAttribute(
            ntt_pass_kernel<LDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(sizeof(u64) << NTT_TILE_LOG));
        if (e != cudaSuccess) return (int)e;
        attr = true;
    }
    ntt_pass_kernel<LDE><<<(unsigned)blocks, NTT_THREADS,
                           sizeof(u64) << log_pts, stream>>>(a);
    return (int)cudaGetLastError();
}

static int fill_passes(NttArgs& a, const int* lg, int P) {
    if (P < 1 || P > NTT_MAX_PASSES) return 0;
    a.P = P;
    for (int q = 0; q < P; q++) a.lg[q] = lg[q];
    return 1;
}

// One pass p of the NTT of [C, 2^log_n] (src -> dst; dst may be src for
// p > 0): lg[0..P) the passes' log2 sizes, G = 2^log_G groups a block,
// stage the pass's w_{n_p}^k, tw_lo / tw_hi the split w_n^e (inverse roots
// for the inverse), scale 1: multiply by ninv (Montgomery) at the stores.
extern "C" int ntt_launch(const void* src, void* dst, long long C, int log_n,
                          const int* lg, int P, int p, int log_G,
                          const void* stage, const void* tw_lo,
                          const void* tw_hi, int h_tw, long long ninv,
                          int scale, void* stream) {
    NttArgs a = {};
    if (!fill_passes(a, lg, P)) return (int)cudaErrorInvalidValue;
    a.src = (const u64*)src; a.dst = (u64*)dst; a.stage = (const u64*)stage;
    a.tw_lo = (const u64*)tw_lo; a.tw_hi = (const u64*)tw_hi;
    a.C = C; a.log_n = log_n; a.log_b = 0; a.p = p; a.log_R = 0;
    a.log_G = log_G; a.h_tw = h_tw; a.scale = scale; a.ninv = (u64)ninv;
    return launch_pass<false>(a, (cudaStream_t)stream);
}

// One pass p of the LDE of coefficients [C, 2^log_n] into [C, 2^(log_b +
// log_n)] over o <w_bn>: R = 2^log_R cosets a block; o_lo / o_hi the split
// o^t (t < n), c_lo / c_hi the split w_bn^e (e < b n), read at pass 0.
extern "C" int lde_launch(const void* src, void* dst, long long C, int log_n,
                          int log_b, const int* lg, int P, int p, int log_R,
                          int log_G, const void* stage, const void* tw_lo,
                          const void* tw_hi, int h_tw, const void* o_lo,
                          const void* o_hi, int h_o, const void* c_lo,
                          const void* c_hi, int h_c, void* stream) {
    NttArgs a = {};
    if (!fill_passes(a, lg, P)) return (int)cudaErrorInvalidValue;
    a.src = (const u64*)src; a.dst = (u64*)dst; a.stage = (const u64*)stage;
    a.tw_lo = (const u64*)tw_lo; a.tw_hi = (const u64*)tw_hi;
    a.o_lo = (const u64*)o_lo; a.o_hi = (const u64*)o_hi;
    a.c_lo = (const u64*)c_lo; a.c_hi = (const u64*)c_hi;
    a.C = C; a.log_n = log_n; a.log_b = log_b; a.p = p; a.log_R = log_R;
    a.log_G = log_G; a.h_tw = h_tw; a.h_o = h_o; a.h_c = h_c; a.scale = 0;
    return launch_pass<true>(a, (cudaStream_t)stream);
}
