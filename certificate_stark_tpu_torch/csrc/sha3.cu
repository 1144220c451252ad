// SHA3-256 commitment hashing: Merkle leaves from rows of field elements, and
// Merkle levels from pairs of digests.
//
// Replaces certificate_stark_tpu/engine/hasher.py `Sha3Hasher`
// `hash_columns` / `merge_pairs` (:150-157), which run
// certificate_stark_tpu/ops/sha3.py `keccak_f` (:87) and `sha3_words`
// (:106) as XLA code. The TPU has no 64-bit integers, so the JAX package
// holds each Keccak lane as two u32 words; here a lane is a u64 in a
// register pair, and the layout of words is the JAX package's: message
// word 2i is the low half of lane i, a digest is lanes 0..3 as 8 LE words.
//
// - sha3_leaves: one thread per row of a [k, B] Montgomery tensor. It reads
//   the row's k elements (neighbouring threads read neighbouring
//   addresses), converts each to standard form with one REDC, and absorbs
//   the 8k bytes (8-byte LE standard form: element i is lane i) at the rate
//   of 17 lanes, with the 0x06 ... 0x80 pad; k/17 + 1 permutations.
// - sha3_merge: one thread per pair of a [8, 2m] level; the SHA3-256 of the
//   64 bytes left || right, one permutation.
// - sha3_tree: every level of a tree above [8, n] leaves, the same merge,
//   in one launch (tree.cuh); the prover's trees. sha3_merge stays for one
//   level (the PoW search of engine/coin.py).
// Digests are written as [8, B] int64 words (u32 values).
//
// Bound on the H100: a 94-element row is 752 bytes read for 6 permutations
// of 24 rounds, some 4,600 32-bit integer instructions a permutation (a
// 64-bit xor, and-not or rotate is two 32-bit ones), so the leaf hash is
// bound by the integer issue rate rather than by device memory
// (chip_smoke.py `_keccak_ops`). The design keeps the 25 lanes in registers,
// unrolls the 24 rounds with the rho/pi lane order and the rotation
// amounts resolved at compile time, and rotates each lane with two funnel
// shifts of its halves.
#include <cuda_runtime.h>

#include "f63.cuh"
#include "tree.cuh"

#define THREADS 128
#define RATE_LANES 17

__constant__ u64 KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

// x rotated left by r, 0 < r < 64, as two funnel shifts of its halves
__device__ __forceinline__ u64 rotl64(u64 x, int r) {
    u32 lo = lo32(x), hi = hi32(x);
    if (r >= 32) {
        const u32 t = lo;
        lo = hi;
        hi = t;
        r -= 32;
    }
    if (r == 0) return join32(lo, hi);
    return join32(__funnelshift_l(hi, lo, r), __funnelshift_l(lo, hi, r));
}

__device__ __forceinline__ void keccak_f(u64 s[25]) {
    // rho rotations and the pi lane order (the tiny-keccak tables)
    constexpr int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
    constexpr int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                              15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll
    for (int round = 0; round < 24; round++) {
        // theta
        u64 c[5];
#pragma unroll
        for (int x = 0; x < 5; x++)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; x++) {
            const u64 d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
            for (int y = 0; y < 25; y += 5) s[y + x] ^= d;
        }
        // rho and pi
        u64 t = s[1];
#pragma unroll
        for (int i = 0; i < 24; i++) {
            const int j = piln[i];
            const u64 u = s[j];
            s[j] = rotl64(t, rotc[i]);
            t = u;
        }
        // chi
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
            u64 row[5];
#pragma unroll
            for (int x = 0; x < 5; x++) row[x] = s[y + x];
#pragma unroll
            for (int x = 0; x < 5; x++)
                s[y + x] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5]);
        }
        // iota
        s[0] ^= KECCAK_RC[round];
    }
}

// Montgomery -> standard form: REDC(v * 1).
__device__ __forceinline__ u64 from_mont(u64 v) {
    return f63_redc(lo32(v), hi32(v), 0u, 0u);
}

__device__ __forceinline__ void write_digest(const u64 s[25],
                                             long long* __restrict__ out,
                                             long long stride, long long j) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
        out[(long long)(2 * i) * stride + j] = lo32(s[i]);
        out[(long long)(2 * i + 1) * stride + j] = hi32(s[i]);
    }
}

// One merge: the SHA3-256 of the 64 bytes left || right, one permutation.
// Lane i is message words 2i (low half) and 2i + 1.
struct Sha3Merge {
    __device__ static __forceinline__ void merge(const u32 msg[16],
                                                 u32 d[8]) {
        u64 s[25];
#pragma unroll
        for (int i = 0; i < 25; i++) s[i] = 0ull;
#pragma unroll
        for (int i = 0; i < 8; i++) s[i] = join32(msg[2 * i], msg[2 * i + 1]);
        s[8] = 0x06ull;
        s[RATE_LANES - 1] = 0x8000000000000000ull;
        keccak_f(s);
#pragma unroll
        for (int i = 0; i < 4; i++) {
            d[2 * i] = lo32(s[i]);
            d[2 * i + 1] = hi32(s[i]);
        }
    }
};

__global__ void __launch_bounds__(THREADS)
sha3_leaves_kernel(const u64* __restrict__ cols, long long* __restrict__ out,
                   int k, long long n) {
    const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (row >= n) return;
    const int nblocks = k / RATE_LANES + 1;
    u64 s[25];
#pragma unroll
    for (int i = 0; i < 25; i++) s[i] = 0ull;
    for (int blk = 0; blk < nblocks; blk++) {
        // lane i of the block is element blk*17 + i, then the pad: 0x06 in
        // the lane after the message, 0x80 in the top byte of the last lane
        // of the last block
#pragma unroll
        for (int i = 0; i < RATE_LANES; i++) {
            const int c = blk * RATE_LANES + i;
            u64 v = 0ull;
            if (c < k)
                v = from_mont(__ldg(cols + (long long)c * n + row));
            else if (c == k)
                v = 0x06ull;
            s[i] ^= v;
        }
        if (blk == nblocks - 1) s[RATE_LANES - 1] ^= 0x8000000000000000ull;
        keccak_f(s);
    }
    write_digest(s, out, n, row);
}

__global__ void __launch_bounds__(THREADS)
sha3_merge_kernel(const long long* __restrict__ level,
                  long long* __restrict__ out, long long m) {
    const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (j >= m) return;
    // words 0..7: the left digest, 8..15: the right one
    u32 msg[16], d[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        msg[i] = (u32)__ldg(level + (long long)i * 2 * m + 2 * j);
        msg[8 + i] = (u32)__ldg(level + (long long)i * 2 * m + 2 * j + 1);
    }
    Sha3Merge::merge(msg, d);
#pragma unroll
    for (int i = 0; i < 8; i++) out[(long long)i * m + j] = d[i];
}

// Every level of a tree above leaves [8, n] into out [8, n - 1]
// (tree.cuh); each thread keeps its Keccak state in registers.
__global__ void __launch_bounds__(TREE_THREADS)
sha3_tree_kernel(const long long* __restrict__ leaves,
                 long long* __restrict__ out, const TreeSchedule sc,
                 int* __restrict__ ctr) {
    tree_body<Sha3Merge>(leaves, out, sc, ctr);
}

// cols: [k, n] Montgomery u64; out: [8, n] int64 words.
extern "C" int sha3_leaves_launch(const void* cols, void* out, int k,
                                  long long n, void* stream) {
    if (n <= 0) return 0;
    long long blocks = (n + THREADS - 1) / THREADS;
    sha3_leaves_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const u64*)cols, (long long*)out, k, n);
    return (int)cudaGetLastError();
}

// level: [8, 2m] int64 words; out: [8, m].
extern "C" int sha3_merge_launch(const void* level, void* out, long long m,
                                 void* stream) {
    if (m <= 0) return 0;
    long long blocks = (m + THREADS - 1) / THREADS;
    sha3_merge_kernel<<<(unsigned)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const long long*)level, (long long*)out, m);
    return (int)cudaGetLastError();
}

// leaves: [8, n] int64 words; out: [8, n - 1]; sched: the stages of
// ops/kernels.py tree_schedule; ctr: the gate counters, zero.
extern "C" int sha3_tree_launch(const void* leaves, void* out,
                                const long long* sched, int nstages,
                                long long n, void* ctr, void* stream) {
    return tree_launch(sha3_tree_kernel, leaves, out, sched, nstages, n, ctr,
                       stream);
}
