// Rescue-XLIX permutation over f63 (state width 14, 7 rounds, alpha = 3).
//
// Replaces certificate_stark_tpu/ops/pallas_kernels.py
// `pallas_rescue_permutation` (:142-160, body `_rescue_perm_kernel`
// :104-139). Template: native/f63.c `rescue_permutation` (:97).
//
// One thread per state. The 14 lanes stay in registers for all 7 rounds;
// the input and output are read and written once, lane-major ([14, N] int64,
// so neighbouring threads touch neighbouring addresses). The MDS matrix and
// the round constants (Montgomery form) sit in __constant__ memory: every
// thread of a warp reads the same entry, which the constant cache broadcasts.
//
// Bound on the H100: a permutation is ~12k Montgomery multiplies against
// 224 bytes of state, and Hopper has no 64-bit integer multiply, so each
// multiply is a chain of 32-bit integer instructions: the kernel is bound by
// integer throughput. The inverse s-box x^INV_ALPHA (61 squarings and 32
// multiplies per lane) is about 76% of the multiplies; it runs the fixed
// square-and-multiply chain over all 14 lanes at once, which gives 14
// independent dependency chains per thread to hide multiply latency.
#include <cuda_runtime.h>

#include "f63.cuh"

#define W 14
#define ROUNDS 7
#define INV_ALPHA 3146514939656186539ULL  // 62 bits, 33 of them set

__constant__ u64 c_mds[W * W];
__constant__ u64 c_ark[8 * 2 * W];

__device__ __forceinline__ void mds_apply(u64 s[W]) {
    u64 t[W];
#pragma unroll
    for (int i = 0; i < W; i++) {
        u64 acc = f63_mmul(c_mds[i * W], s[0]);
#pragma unroll
        for (int j = 1; j < W; j++)
            acc = f63_add(acc, f63_mmul(c_mds[i * W + j], s[j]));
        t[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < W; i++) s[i] = t[i];
}

__global__ void rescue_perm_kernel(const u64* __restrict__ in,
                                   u64* __restrict__ out, long long n) {
    long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= n) return;
    u64 s[W];
#pragma unroll
    for (int j = 0; j < W; j++) s[j] = in[j * n + col];

#pragma unroll 1
    for (int r = 0; r < ROUNDS; r++) {
        // s-box x^3
#pragma unroll
        for (int j = 0; j < W; j++) s[j] = f63_mmul(s[j], f63_mmul(s[j], s[j]));
        mds_apply(s);
#pragma unroll
        for (int j = 0; j < W; j++) s[j] = f63_add(s[j], c_ark[r * 2 * W + j]);
        // inverse s-box x^INV_ALPHA, MSB-first square-and-multiply
        u64 x[W];
#pragma unroll
        for (int j = 0; j < W; j++) x[j] = s[j];
#pragma unroll 1
        for (int bit = 60; bit >= 0; bit--) {
#pragma unroll
            for (int j = 0; j < W; j++) s[j] = f63_mmul(s[j], s[j]);
            if ((INV_ALPHA >> bit) & 1ULL) {
#pragma unroll
                for (int j = 0; j < W; j++) s[j] = f63_mmul(s[j], x[j]);
            }
        }
        mds_apply(s);
#pragma unroll
        for (int j = 0; j < W; j++)
            s[j] = f63_add(s[j], c_ark[r * 2 * W + W + j]);
    }

#pragma unroll
    for (int j = 0; j < W; j++) out[j * n + col] = s[j];
}

// in, out: [14, n] u64 on the device; mds: [14, 14] and ark: [8, 28]
// Montgomery tables on the device, copied into constant memory on `stream`
// ahead of the launch.
extern "C" int rescue_perm_launch(const void* in, void* out, long long n,
                                  const void* mds, const void* ark,
                                  void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemcpyToSymbolAsync(c_mds, mds, sizeof(u64) * W * W, 0,
                                            cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbolAsync(c_ark, ark, sizeof(u64) * 8 * 2 * W, 0,
                                cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
    if (n <= 0) return 0;
    const int threads = 128;
    long long blocks = (n + threads - 1) / threads;
    rescue_perm_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        (const u64*)in, (u64*)out, n);
    return (int)cudaGetLastError();
}
