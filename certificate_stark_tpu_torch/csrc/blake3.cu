// BLAKE3-256 commitment hashing: Merkle leaves from rows of field elements,
// and Merkle levels from pairs of digests.
//
// Replaces certificate_stark_tpu/engine/hasher.py `Blake3Hasher`
// `hash_columns` / `merge_pairs` (:115-122), which run
// certificate_stark_tpu/ops/blake3.py `blake3_words` (:124-148) as XLA code.
// Templates: native/air_eval.c `blake3_leaves` (:408) and
// `blake3_merge_level` (:421).
//
// - blake3_leaves: one thread per row of a [k, B] Montgomery tensor (k <= 128
//   elements, one chunk). It reads the row's k elements (neighbouring
//   threads read neighbouring addresses), converts each to standard form
//   with one REDC, and hashes the 8k bytes (8-byte LE standard form) as one
//   chunk: CHUNK_START on the first block, CHUNK_END | ROOT on the last.
// - blake3_merge: one thread per pair of a [8, 2m] level; the single-chunk
//   hash of the 64 bytes left || right (the JAX package's `merge_pairs`, not
//   BLAKE3's PARENT node).
// - blake3_tree: every level of a tree above [8, n] leaves, the same merge,
//   in one launch (tree.cuh); the prover's trees. blake3_merge stays for
//   one level (the PoW search of engine/coin.py).
// Digests are written as [8, B] int64 words (u32 values).
//
// Bound on the H100: a 94-element row is 752 bytes read for 12 compressions
// of some 680 32-bit integer instructions each (add, xor, funnel-shift
// rotate), so the leaf hash is bound by the integer issue rate rather than
// by device memory (chip_smoke.py `BLAKE3_OPS`); a merge reads 128 bytes
// for one compression. The design keeps the 16-word state and the 16
// message words in registers, unrolls the 7 rounds with the message
// schedule resolved at compile time, and rotates with funnel shifts.
#include <cuda_runtime.h>

#include "f63.cuh"
#include "tree.cuh"

__constant__ u32 B3_IV[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                             0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                             0x1f83d9abu, 0x5be0cd19u};

#define CHUNK_START 1u
#define CHUNK_END 2u
#define ROOT 8u
#define THREADS 128

__device__ __forceinline__ u32 rotr(u32 x, int n) {
    return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void g(u32 v[16], int a, int b, int c, int d,
                                  u32 mx, u32 my) {
    v[a] = v[a] + v[b] + mx;
    v[d] = rotr(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 12);
    v[a] = v[a] + v[b] + my;
    v[d] = rotr(v[d] ^ v[a], 8);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 7);
}

// One round: 4 column and 4 diagonal mixes, message words s0..s15 of the
// round's schedule (MSG_PERM applied r times, written out below).
#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13,   \
              s14, s15)                                                     \
    g(v, 0, 4, 8, 12, m[s0], m[s1]);                                        \
    g(v, 1, 5, 9, 13, m[s2], m[s3]);                                        \
    g(v, 2, 6, 10, 14, m[s4], m[s5]);                                       \
    g(v, 3, 7, 11, 15, m[s6], m[s7]);                                       \
    g(v, 0, 5, 10, 15, m[s8], m[s9]);                                       \
    g(v, 1, 6, 11, 12, m[s10], m[s11]);                                     \
    g(v, 2, 7, 8, 13, m[s12], m[s13]);                                      \
    g(v, 3, 4, 9, 14, m[s14], m[s15])

// cv <- compress(cv, m, counter 0, block_len, flags)
__device__ __forceinline__ void compress(u32 cv[8], const u32 m[16],
                                         u32 block_len, u32 flags) {
    u32 v[16];
#pragma unroll
    for (int i = 0; i < 8; i++) v[i] = cv[i];
#pragma unroll
    for (int i = 0; i < 4; i++) v[8 + i] = B3_IV[i];
    v[12] = 0u;
    v[13] = 0u;
    v[14] = block_len;
    v[15] = flags;
    ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    ROUND(2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8);
    ROUND(3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1);
    ROUND(10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6);
    ROUND(12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4);
    ROUND(9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7);
    ROUND(11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13);
#pragma unroll
    for (int i = 0; i < 8; i++) cv[i] = v[i] ^ v[i + 8];
}

// Montgomery -> standard form: REDC(v * 1).
__device__ __forceinline__ u64 from_mont(u64 v) {
    return f63_redc(lo32(v), hi32(v), 0u, 0u);
}

__global__ void __launch_bounds__(THREADS)
blake3_leaves_kernel(const u64* __restrict__ cols, long long* __restrict__ out,
                     int k, long long n) {
    const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (row >= n) return;
    const int nbytes = 8 * k;
    const int nblocks = (nbytes + 63) / 64;
    u32 cv[8];
#pragma unroll
    for (int i = 0; i < 8; i++) cv[i] = B3_IV[i];
    for (int blk = 0; blk < nblocks; blk++) {
        // a block holds the 8 elements blk*8 .. blk*8+7 of the row
        u32 m[16];
#pragma unroll
        for (int e = 0; e < 8; e++) {
            const int c = blk * 8 + e;
            u64 v = c < k ? from_mont(__ldg(cols + (long long)c * n + row))
                          : 0ull;
            m[2 * e] = lo32(v);
            m[2 * e + 1] = hi32(v);
        }
        const bool last = blk == nblocks - 1;
        const u32 blen = last ? (u32)(nbytes - 64 * blk) : 64u;
        const u32 flags = (blk == 0 ? CHUNK_START : 0u) |
                          (last ? CHUNK_END | ROOT : 0u);
        compress(cv, m, blen, flags);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) out[(long long)i * n + row] = cv[i];
}

// One merge: the single-chunk hash of the 64 bytes left || right.
struct Blake3Merge {
    __device__ static __forceinline__ void merge(const u32 msg[16],
                                                 u32 cv[8]) {
#pragma unroll
        for (int i = 0; i < 8; i++) cv[i] = B3_IV[i];
        compress(cv, msg, 64u, CHUNK_START | CHUNK_END | ROOT);
    }
};

__global__ void __launch_bounds__(THREADS)
blake3_merge_kernel(const long long* __restrict__ level,
                    long long* __restrict__ out, long long m) {
    const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (j >= m) return;
    u32 msg[16], cv[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
        msg[i] = (u32)__ldg(level + (long long)i * 2 * m + 2 * j);
        msg[8 + i] = (u32)__ldg(level + (long long)i * 2 * m + 2 * j + 1);
    }
    Blake3Merge::merge(msg, cv);
#pragma unroll
    for (int i = 0; i < 8; i++) out[(long long)i * m + j] = cv[i];
}

// Every level of a tree above leaves [8, n] into out [8, n - 1]
// (tree.cuh).
__global__ void __launch_bounds__(TREE_THREADS)
blake3_tree_kernel(const long long* __restrict__ leaves,
                   long long* __restrict__ out, const TreeSchedule sc,
                   int* __restrict__ ctr) {
    tree_body<Blake3Merge>(leaves, out, sc, ctr);
}

// cols: [k, n] Montgomery u64; out: [8, n] int64 words.
extern "C" int blake3_leaves_launch(const void* cols, void* out, int k,
                                    long long n, void* stream) {
    if (n <= 0) return 0;
    long long blocks = (n + THREADS - 1) / THREADS;
    blake3_leaves_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const u64*)cols, (long long*)out, k, n);
    return (int)cudaGetLastError();
}

// level: [8, 2m] int64 words; out: [8, m].
extern "C" int blake3_merge_launch(const void* level, void* out, long long m,
                                   void* stream) {
    if (m <= 0) return 0;
    long long blocks = (m + THREADS - 1) / THREADS;
    blake3_merge_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const long long*)level, (long long*)out, m);
    return (int)cudaGetLastError();
}

// leaves: [8, n] int64 words; out: [8, n - 1]; sched: the stages of
// ops/kernels.py tree_schedule; ctr: the gate counters, zero.
extern "C" int blake3_tree_launch(const void* leaves, void* out,
                                  const long long* sched, int nstages,
                                  long long n, void* ctr, void* stream) {
    return tree_launch(blake3_tree_kernel, leaves, out, sched, nstages, n,
                       ctr, stream);
}
