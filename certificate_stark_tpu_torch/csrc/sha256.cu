// SHA-256 commitment hashing: Merkle leaves from rows of field elements,
// Merkle levels from pairs of digests, and whole Merkle trees.
//
// Replaces certificate_stark_tpu/engine/hasher.py `Sha256Hasher`
// `hash_columns` / `merge_pairs` (:76-87), which run
// certificate_stark_tpu/ops/sha256.py `_compress` (:41), `sha256_words`
// (:82) and `felems_to_words` (:115) as XLA code, and
// certificate_stark_tpu/engine/kernels.py `tree_levels` (:22), one of those
// merges a level.
//
// - sha256_leaves: one thread per row of a [k, B] Montgomery tensor. It
//   reads the row's k elements (neighbouring threads read neighbouring
//   addresses), converts each to standard form with one REDC, and hashes
//   the 8k bytes (8-byte LE standard form; the big-endian message words
//   are the byte-swapped halves of each element) with the SHA-256 pad: the
//   0x80 word, zeros, and the 64-bit bit length as two words.
// - sha256_merge: one thread per pair of a [8, 2m] level; the SHA-256 of the
//   64 bytes left || right (the digests' big-endian words as they are),
//   two compressions (Sha256Merge). It stays for the PoW search, one level.
// - sha256_tree: every level of a tree in one launch (tree.cuh) over the
//   same merge.
// Digests are written as [8, B] int64 words (u32 values, big-endian words).
//
// Bound on the H100: a 94-element row is 752 bytes read for 12 compressions
// of some 1,400 32-bit integer instructions each (three-input adds and
// logic, funnel-shift rotates), so the leaf hash is bound by the integer
// issue rate rather than by device memory (chip_smoke.py `SHA256_OPS`); so
// is a merge, whose second compression is of the constant pad block: its
// message schedule and round constants are folded into one table at
// compile time (SHA256_MERGE_OPS). The design keeps the 8-word state and a
// 16-word ring of the message schedule in registers, unrolls the 64 rounds
// so that every schedule index and round constant is resolved at compile
// time, and rotates with funnel shifts.
#include <cuda_runtime.h>

#include "f63.cuh"
#include "tree.cuh"

#define THREADS 128

__constant__ u32 SHA256_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__constant__ u32 SHA256_IV[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                                 0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                                 0x1f83d9abu, 0x5be0cd19u};

__device__ __forceinline__ u32 rotr(u32 x, int n) {
    return __funnelshift_r(x, x, n);
}

// state <- compress(state, w); w is consumed as the schedule's ring
__device__ __forceinline__ void compress(u32 state[8], u32 w[16]) {
    u32 a = state[0], b = state[1], c = state[2], d = state[3];
    u32 e = state[4], f = state[5], g = state[6], h = state[7];
#pragma unroll
    for (int i = 0; i < 64; i++) {
        if (i >= 16) {
            const u32 w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
            const u32 s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const u32 s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            w[i & 15] += s0 + w[(i - 7) & 15] + s1;
        }
        const u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        const u32 ch = (e & f) ^ (~e & g);
        const u32 t1 = h + S1 + ch + SHA256_K[i] + w[i & 15];
        const u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        const u32 maj = (a & b) ^ (a & c) ^ (b & c);
        h = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + S0 + maj;
    }
    state[0] += a;
    state[1] += b;
    state[2] += c;
    state[3] += d;
    state[4] += e;
    state[5] += f;
    state[6] += g;
    state[7] += h;
}

// state <- compress(state, the pad block of a 64-byte message: 0x80000000,
// zeros, the bit length 512). Its schedule is constant: PAD_KW[i] = K[i] +
// W[i], so the rounds take immediates and the block needs no schedule work
// (tests/test_torch_merkle_tree.py holds the table to hashlib). The rounds
// repeat compress's: one round function shared by both gave sha256_leaves
// another register allocation, 7-8% slower on the H100 (PERF.md §6).
__device__ __forceinline__ void compress_pad64(u32 state[8]) {
    constexpr u32 PAD_KW[64] = {
        0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
        0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
        0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
        0xc19bf374u, 0x649b69c1u, 0xf0fe4786u, 0x0fe1edc6u, 0x240cf254u,
        0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau, 0xf2c65152u,
        0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
        0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu,
        0xdc1eeefdu, 0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u,
        0x007f3e86u, 0x37088980u, 0xa507ea32u, 0x6fab9537u, 0x17406110u,
        0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u, 0x83613bdau, 0xdb48a363u,
        0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u, 0x6ed41a95u,
        0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
        0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u};
    u32 a = state[0], b = state[1], c = state[2], d = state[3];
    u32 e = state[4], f = state[5], g = state[6], h = state[7];
#pragma unroll
    for (int i = 0; i < 64; i++) {
        // compress's round, K[i] + W[i] given whole
        const u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        const u32 ch = (e & f) ^ (~e & g);
        const u32 t1 = h + S1 + ch + PAD_KW[i];
        const u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        const u32 maj = (a & b) ^ (a & c) ^ (b & c);
        h = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + S0 + maj;
    }
    state[0] += a;
    state[1] += b;
    state[2] += c;
    state[3] += d;
    state[4] += e;
    state[5] += f;
    state[6] += g;
    state[7] += h;
}

// One merge: the SHA-256 of the 64 bytes left || right, message word w of
// the left digest, then word w of the right (big-endian words as they are).
struct Sha256Merge {
    __device__ static __forceinline__ void merge(const u32 msg[16],
                                                 u32 d[8]) {
        u32 w[16];   // compress consumes its ring
#pragma unroll
        for (int i = 0; i < 16; i++) w[i] = msg[i];
#pragma unroll
        for (int i = 0; i < 8; i++) d[i] = SHA256_IV[i];
        compress(d, w);
        compress_pad64(d);
    }
};

// Montgomery -> standard form: REDC(v * 1).
__device__ __forceinline__ u64 from_mont(u64 v) {
    return f63_redc(lo32(v), hi32(v), 0u, 0u);
}

__global__ void __launch_bounds__(THREADS)
sha256_leaves_kernel(const u64* __restrict__ cols, long long* __restrict__ out,
                     int k, long long n) {
    const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (row >= n) return;
    const int nwords = 2 * k;
    const int nblocks = (nwords + 1 + 2 + 15) / 16;
    const u64 bitlen = 64ull * (u64)k;
    u32 st[8];
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = SHA256_IV[i];
    for (int blk = 0; blk < nblocks; blk++) {
        // a block holds the 16 words of elements blk*8 .. blk*8+7, then the
        // pad where the message has ended
        const bool last = blk == nblocks - 1;
        u32 w[16];
#pragma unroll
        for (int e = 0; e < 8; e++) {
            const int c = blk * 8 + e;
            u32 lo = 0u, hi = 0u;
            if (c < k) {
                const u64 v = from_mont(__ldg(cols + (long long)c * n + row));
                lo = __byte_perm(lo32(v), 0u, 0x0123);
                hi = __byte_perm(hi32(v), 0u, 0x0123);
            } else if (2 * c == nwords) {
                lo = 0x80000000u;
            }
            w[2 * e] = lo;
            w[2 * e + 1] = hi;
        }
        if (last) {
            w[14] = (u32)(bitlen >> 32);
            w[15] = (u32)bitlen;
        }
        compress(st, w);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) out[(long long)i * n + row] = st[i];
}

__global__ void __launch_bounds__(THREADS)
sha256_merge_kernel(const long long* __restrict__ level,
                    long long* __restrict__ out, long long m) {
    const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (j >= m) return;
    u32 msg[16], d[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        msg[i] = (u32)__ldg(level + (long long)i * 2 * m + 2 * j);
        msg[8 + i] = (u32)__ldg(level + (long long)i * 2 * m + 2 * j + 1);
    }
    Sha256Merge::merge(msg, d);
#pragma unroll
    for (int i = 0; i < 8; i++) out[(long long)i * m + j] = d[i];
}

// Every level of a tree above leaves [8, n] into out [8, n - 1]
// (tree.cuh).
__global__ void __launch_bounds__(TREE_THREADS)
sha256_tree_kernel(const long long* __restrict__ leaves,
                   long long* __restrict__ out, const TreeSchedule sc,
                   int* __restrict__ ctr) {
    tree_body<Sha256Merge>(leaves, out, sc, ctr);
}

// cols: [k, n] Montgomery u64; out: [8, n] int64 words.
extern "C" int sha256_leaves_launch(const void* cols, void* out, int k,
                                    long long n, void* stream) {
    if (n <= 0) return 0;
    long long blocks = (n + THREADS - 1) / THREADS;
    sha256_leaves_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const u64*)cols, (long long*)out, k, n);
    return (int)cudaGetLastError();
}

// level: [8, 2m] int64 words; out: [8, m].
extern "C" int sha256_merge_launch(const void* level, void* out, long long m,
                                   void* stream) {
    if (m <= 0) return 0;
    long long blocks = (m + THREADS - 1) / THREADS;
    sha256_merge_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const long long*)level, (long long*)out, m);
    return (int)cudaGetLastError();
}


// leaves: [8, n] int64 words; out: [8, n - 1]; sched: the stages of
// ops/kernels.py tree_schedule; ctr: the gate counters, zero.
extern "C" int sha256_tree_launch(const void* leaves, void* out,
                                  const long long* sched, int nstages,
                                  long long n, void* ctr, void* stream) {
    return tree_launch(sha256_tree_kernel, leaves, out, sched, nstages, n,
                       ctr, stream);
}
