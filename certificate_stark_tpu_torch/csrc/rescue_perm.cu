// Rescue-XLIX permutation over f63 (state width 14, 7 rounds, alpha = 3).
//
// Replaces certificate_stark_tpu/ops/pallas_kernels.py
// `pallas_rescue_permutation` (:143, body `_rescue_perm_kernel` :104-139).
//
// Bound on the H100: a permutation moves 224 bytes in and out against some
// 10^5 32-bit multiplies (chip_smoke.py MULS_PER_PERM), so the kernel is
// bound by the rate at which the SMs issue integer instructions, and by the
// latency of one thread's chain of dependent multiplies where a launch has
// too few states to fill the card (most Merkle levels have 2^14 states or
// fewer). What the design does about it:
// - one state per group of 16 threads (lanes 0-13 active, 2 states a warp),
//   so a launch of N states runs 16N threads and a small Merkle level takes
//   about 1/14 of the time one thread needs for a whole state. Each thread
//   keeps its lane, its MDS row (14 values in registers, loaded once from
//   the device table) and reads its two round constants a round. The
//   s-boxes are per lane; an MDS layer gathers the 14 lanes of the group
//   with shuffles;
// - word-level Montgomery arithmetic (f63.cuh): two 32-bit REDC steps with
//   no multiply for m, and squarings from three partial products;
// - one reduction per MDS output: the 14 unreduced 128-bit products of a
//   row are summed (14 (p-1)^2 < 2^128) and reduced once;
// - x^INV_ALPHA by the addition chain of ops/kernels.py INV_ALPHA_CHAIN,
//   61 squarings and 12 multiplies in place of 61 and 32;
// - the tables are read through the device pointers the wrapper passes:
//   nothing is copied per launch.
#include <cuda_runtime.h>

#include "f63.cuh"

#define W 14        // state width
#define ROUNDS 7
#define GROUP 16    // threads a state: lanes 0-13 active, 14-15 idle
#define THREADS 128

// Lane `row` of the MDS product: sum_j mds[row][j] * s_j, with s_j the
// value of lane j of this thread's group, reduced once.
__device__ __forceinline__ u64 mds_row(const u64 m[W], u64 s) {
    u32 c[4];
    u64 s0 = join32(__shfl_sync(0xffffffffu, lo32(s), 0, GROUP),
                    __shfl_sync(0xffffffffu, hi32(s), 0, GROUP));
    f63_mul_wide(m[0], s0, c[0], c[1], c[2], c[3]);
#pragma unroll
    for (int j = 1; j < W; j++) {
        u64 sj = join32(__shfl_sync(0xffffffffu, lo32(s), j, GROUP),
                        __shfl_sync(0xffffffffu, hi32(s), j, GROUP));
        f63_mac(c, m[j], sj);
    }
    return f63_redc_wide(c);
}

__global__ void __launch_bounds__(THREADS)
rescue_perm_group(const u64* __restrict__ in, u64* __restrict__ out,
                  long long n, const u64* __restrict__ mds,
                  const u64* __restrict__ ark) {
    const long long col =
        ((long long)blockIdx.x * THREADS + threadIdx.x) / GROUP;
    const int lane = threadIdx.x % GROUP;
    // idle lanes and states past n run row 0 along; no lane reads them
    const int row = lane < W ? lane : 0;
    const bool live = lane < W && col < n;
    u64 m[W];
#pragma unroll
    for (int j = 0; j < W; j++) m[j] = __ldg(mds + row * W + j);
    u64 s = live ? in[lane * n + col] : 0;
#pragma unroll 1
    for (int r = 0; r < ROUNDS; r++) {
        s = f63_mmul(f63_msqr(s), s);
        s = f63_add(mds_row(m, s), __ldg(ark + r * 2 * W + row));
        s = f63_inv_sbox(s);
        s = f63_add(mds_row(m, s), __ldg(ark + r * 2 * W + W + row));
    }
    if (live) out[lane * n + col] = s;
}

// in, out: [14, n] u64 on the device; mds: [14, 14] and ark: [8, 28]
// Montgomery tables on the device.
extern "C" int rescue_perm_launch(const void* in, void* out, long long n,
                                  const void* mds, const void* ark,
                                  void* stream) {
    if (n <= 0) return 0;
    long long blocks = (n * GROUP + THREADS - 1) / THREADS;
    rescue_perm_group<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, n, (const u64*)mds, (const u64*)ark);
    return (int)cudaGetLastError();
}
