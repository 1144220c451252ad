// A whole Merkle tree in one launch: every level above the leaves, for a
// hash whose merge maps 16 message words (left || right digest) to an
// 8-word digest. Included by blake3.cu, sha256.cu and sha3.cu, which
// instantiate tree_body with their merge.
//
// Replaces the per-level loop of certificate_stark_tpu/engine/kernels.py
// `tree_levels` (:22), one XLA merge a level, which the port first ran as
// one launch of blake3_merge / sha256_merge / sha3_merge a level (a
// 2^20-leaf tree: 20 launches, all but the two largest bound by launch
// latency).
//
// Layout: leaves [8, n] int64 words (u32 values), n = 2^L; out [8, n - 1],
// level l (n / 2^l digests, l = 1 .. L) from column n - n / 2^(l-1); the
// root is column n - 2.
//
// Schedule (ops/kernels.py `tree_schedule`, passed in as TreeSchedule):
// stage 0 runs one block of 256 threads a subtree of `size` <= TREE_SUB
// leaves (2^11, or 2^10 for trees below 2^19 leaves). The block hashes
// level 1 from device memory, pair p on thread p (word w of neighbouring
// pairs from neighbouring addresses), the levels above in shared memory,
// ping-pong between two arrays with __syncthreads() between levels, and
// writes each level's digests to `out` coalesced. A block that finished a
// subtree of stage i - 1 fences its writes and counts itself at counter
// `ctr + unit / size` of stage i; the last of each group of `size` hashes
// the group's roots as its subtree of stage i (the last-block-done
// pattern), so the whole tree takes one launch. Stage i >= 1 reads its
// inputs through L2 (__ldcg): other blocks wrote them in this launch. The
// last block zeroes its counter, so the counters stay zero between
// launches.
//
// Bound on the H100: n - 1 merges (one compression or permutation each,
// two for SHA-256), so the integer issue rate bounds BLAKE3, SHA-256 and
// SHA3 trees alike; the leaves and the n - 1 digests cross device memory
// once (for BLAKE3 nearly as long). What the design leaves
// on the table: threads idle as a subtree's levels shrink below 256 pairs
// (a quarter of the work, eight levels of one merge's latency each), and
// the blocks an SM holds reach those levels together; the top stage runs
// alone. The other schedules tried did no better (PERF.md, PR 10).
#pragma once
#include <cuda_runtime.h>

#include "f63.cuh"

#define TREE_LOG2 11                  // ops/kernels.py TREE_LOG2
#define TREE_SUB (1 << TREE_LOG2)     // digests a block's subtree holds
#define TREE_THREADS 256
#define TREE_MAX_STAGES 8
#define TREE_STAGE_WORDS 5            // m, size, levels, src_col, ctr

// One stage: its input level holds m digests (the leaves where it is
// stage 0, else the buffer's columns src_col ..), cut into subtrees of
// `size` digests, `levels` = log2(size), one block each; a block of a later
// stage is the last of each `size` blocks of the stage before, counted at
// ctr + unit / size.
struct TreeStage {
    long long m, size, src_col, ctr;
    int levels;
};

struct TreeSchedule {
    long long n;
    int nstages;
    TreeStage st[TREE_MAX_STAGES];
};

// MERGE::merge(const u32 msg[16], u32 digest[8])
template <class MERGE>
__device__ __forceinline__ void tree_body(const long long* __restrict__ leaves,
                                          long long* __restrict__ out,
                                          const TreeSchedule& sc,
                                          int* __restrict__ ctr) {
    // a subtree's odd levels in `a`, its even levels in `b` (24 TREE_SUB
    // bytes)
    __shared__ u32 a[8][TREE_SUB / 2];
    __shared__ u32 b[8][TREE_SUB / 4];
    const long long n = sc.n, ostride = n - 1;
    const int tid = threadIdx.x;
    long long unit = blockIdx.x;
    for (int i = 0; i < sc.nstages; i++) {
        const TreeStage st = sc.st[i];
        if (i > 0) {
            // the last block of its group of `size` goes on, and zeroes the
            // group's counter for the next launch
            __threadfence();
            __syncthreads();
            int last = 0;
            if (tid == 0) {
                int* c = ctr + st.ctr + unit / st.size;
                last = atomicAdd(c, 1) == (int)st.size - 1;
                if (last) *c = 0;
            }
            if (!__syncthreads_or(last)) return;
            __threadfence();
            unit /= st.size;
        }
        // level 1 from device memory (the leaves, or through L2 the digests
        // other blocks wrote in this launch), pair p from thread p: word w
        // of neighbouring pairs from neighbouring addresses; the levels
        // above from shared memory, `a` to `b` and back. Each level's
        // digests go to `out` coalesced.
        const long long* src = i == 0 ? leaves : out;
        const long long stride = i == 0 ? n : ostride;
        const long long c0 = st.src_col + unit * st.size;
        u32 *rd = &b[0][0], *wr = &a[0][0];
        int rs = TREE_SUB / 4, ws = TREE_SUB / 2;   // their word strides
        int pairs = (int)st.size;
        long long cout = st.m;
        for (int j = 1; j <= st.levels; j++) {
            if (j > 1) __syncthreads();
            pairs >>= 1;
            cout >>= 1;              // digests of the output level
            const long long o0 = n - 2 * cout + unit * pairs;
            for (int p = tid; p < pairs; p += TREE_THREADS) {
                u32 msg[16], d[8];
                if (j > 1) {
#pragma unroll
                    for (int w = 0; w < 8; w++) {
                        msg[w] = rd[w * rs + 2 * p];
                        msg[8 + w] = rd[w * rs + 2 * p + 1];
                    }
                } else {
#pragma unroll
                    for (int w = 0; w < 8; w++) {
                        const long long* at = src + w * stride + c0 + 2 * p;
                        if (i == 0) {
                            msg[w] = (u32)__ldg(at);
                            msg[8 + w] = (u32)__ldg(at + 1);
                        } else {
                            msg[w] = (u32)__ldcg(at);
                            msg[8 + w] = (u32)__ldcg(at + 1);
                        }
                    }
                }
                MERGE::merge(msg, d);
#pragma unroll
                for (int w = 0; w < 8; w++) {
                    wr[w * ws + p] = d[w];
                    out[w * ostride + o0 + p] = d[w];
                }
            }
            u32* t = rd;
            rd = wr;
            wr = t;
            const int u = rs;
            rs = ws;
            ws = u;
        }
    }
}

// Reads the schedule (TREE_STAGE_WORDS int64 a stage, host memory) and
// launches `kernel` on one block a subtree of stage 0, on `stream`. The
// gate counters `ctr` must be zero; the kernel leaves them zero. Returns a
// cudaError_t.
template <class KERNEL>
static int tree_launch(KERNEL kernel, const void* leaves, void* out,
                       const long long* sched, int nstages, long long n,
                       void* ctr, void* stream) {
    if (nstages <= 0) return 0;
    if (nstages > TREE_MAX_STAGES) return (int)cudaErrorInvalidValue;
    TreeSchedule sc;
    sc.n = n;
    sc.nstages = nstages;
    for (int i = 0; i < nstages; i++) {
        const long long* s = sched + TREE_STAGE_WORDS * i;
        sc.st[i].m = s[0];
        sc.st[i].size = s[1];
        sc.st[i].levels = (int)s[2];
        sc.st[i].src_col = s[3];
        sc.st[i].ctr = s[4];
        if (s[1] < 2 || s[1] > TREE_SUB || (1ll << s[2]) != s[1] ||
            s[0] % s[1] != 0)
            return (int)cudaErrorInvalidValue;
    }
    const long long blocks = sc.st[0].m / sc.st[0].size;
    kernel<<<(unsigned)blocks, TREE_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)leaves, (long long*)out, sc, (int*)ctr);
    return (int)cudaGetLastError();
}
