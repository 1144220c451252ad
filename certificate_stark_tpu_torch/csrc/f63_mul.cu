// Elementwise f63 Montgomery multiply, out[i] = a[i] * b[i] * 2^-64 mod p.
//
// Replaces certificate_stark_tpu/ops/pallas_kernels.py `pallas_mul` (:176-191,
// body `_mul_kernel` / `_k_mul`). One thread per element; the product is
// four 32x32->64 partial products plus a word-level REDC (f63.cuh).
//
// Bound on the H100: 24 bytes move per element (two reads, one write) against
// some 25 32-bit integer instructions, so at large n the kernel is bound by
// device-memory bandwidth; its design keeps each element to one coalesced
// 8-byte load per operand and one store.
#include <cuda_runtime.h>

#include "f63.cuh"

__global__ void f63_mul_kernel(const u64* __restrict__ a,
                               const u64* __restrict__ b,
                               u64* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = f63_mmul(a[i], b[i]);
}

extern "C" int f63_mul_launch(const void* a, const void* b, void* out,
                              long long n, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    f63_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64*)a, (const u64*)b, (u64*)out, n);
    return (int)cudaGetLastError();
}
