// f63 Montgomery arithmetic for Hopper kernels.
//
// p = 2^62 + 2^56 + 2^55 + 1, Montgomery R = 2^64. A field element is the
// canonical (< p) Montgomery u64 bit pattern, the layout of the port's int64
// tensors. Template: native/air_eval.c `mmul` (lines 32-38).
#pragma once
#include <stdint.h>

typedef unsigned long long u64;

#define F63_P 4719772409484279809ULL       // 2^62 + 2^56 + 2^55 + 1
#define F63_NPRIME 0x417fffffffffffffULL   // -p^-1 mod 2^64

__device__ __forceinline__ u64 f63_add(u64 a, u64 b) {
    u64 s = a + b;  // a, b < p < 2^63: no wrap
    return s >= F63_P ? s - F63_P : s;
}

// High 64 bits of m * p, with p sparse: m*p = (m<<62) + (m<<56) + (m<<55) + m
// summed as 128-bit values (no multiply).
__device__ __forceinline__ u64 f63_mulhi_p(u64 m) {
    u64 hi = (m >> 2) + (m >> 8) + (m >> 9);
    u64 l1 = m << 62, l2 = m << 56, l3 = m << 55;
    u64 s = l1 + l2;
    hi += (s < l1);
    u64 s2 = s + l3;
    hi += (s2 < s);
    u64 s3 = s2 + m;
    hi += (s3 < s2);
    return hi;
}

// REDC(a * b) = a * b * 2^-64 mod p, canonical.
__device__ __forceinline__ u64 f63_mmul(u64 a, u64 b) {
    u64 lo = a * b;
    u64 hi = __umul64hi(a, b);
    u64 m = lo * F63_NPRIME;
    // t + m*p is divisible by 2^64; its low words sum to 0 or 2^64, which
    // carries exactly when lo != 0
    u64 u = hi + f63_mulhi_p(m) + (lo != 0);  // < 2p
    return u >= F63_P ? u - F63_P : u;
}
