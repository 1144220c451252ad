// f63 Montgomery arithmetic for Hopper kernels, on 32-bit words.
//
// p = 2^62 + 2^56 + 2^55 + 1 = K * 2^32 + 1 with K = 0x41800000, Montgomery
// R = 2^64. A field element is the canonical (< p) Montgomery u64 bit
// pattern, the layout of the port's int64 tensors.
//
// Hopper has no 64-bit integer multiply, so products are four 32x32->64
// partial products in PTX carry chains (mad.lo.cc / madc.hi.cc / addc), and
// REDC runs as two 32-bit steps. p = 1 (mod 2^32), so -p^-1 = -1 (mod 2^32)
// and a step takes m = -t0 with no multiply: t + m*p = t + m + (m*K)*2^32,
// whose low word is 0 and carries exactly when t0 != 0. A step is one
// 32x32->64 multiply-add into the words above. Every value stays canonical
// with one conditional subtraction: operands in [0, 2p) would not close
// under REDC for this p (4p > 2^64).
//
// The word-level arithmetic is modelled op for op in Python ints by
// tests/test_torch_rescue_kernel.py.
#pragma once
#include <stdint.h>

typedef unsigned int u32;
typedef unsigned long long u64;

#define F63_P 4719772409484279809ULL  // 2^62 + 2^56 + 2^55 + 1
#define F63_K 0x41800000u             // p >> 32

__device__ __forceinline__ u32 lo32(u64 x) { return (u32)x; }
__device__ __forceinline__ u32 hi32(u64 x) { return (u32)(x >> 32); }
__device__ __forceinline__ u64 join32(u32 lo, u32 hi) {
    return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 f63_sub_p(u64 u) {
    return u >= F63_P ? u - F63_P : u;
}

__device__ __forceinline__ u64 f63_add(u64 a, u64 b) {
    return f63_sub_p(a + b);  // a, b < p < 2^63: no wrap
}

// t = (t3 t2 t1 t0) < p * 2^64  ->  t * 2^-64 mod p, canonical.
__device__ __forceinline__ u64 f63_redc(u32 t0, u32 t1, u32 t2, u32 t3) {
    u32 z, m = 0u - t0;
    // t += m*p; the low word becomes 0; the 96 bits above stay < 2^95
    asm("add.cc.u32      %0, %4, %5;\n\t"
        "madc.lo.cc.u32  %1, %5, %6, %1;\n\t"
        "madc.hi.cc.u32  %2, %5, %6, %2;\n\t"
        "addc.u32        %3, %3, 0;"
        : "=&r"(z), "+r"(t1), "+r"(t2), "+r"(t3)
        : "r"(t0), "r"(m), "r"(F63_K));
    m = 0u - t1;
    // the second step leaves (t + M*p) / 2^64 < 2p in (t3 t2)
    asm("add.cc.u32      %0, %3, %4;\n\t"
        "madc.lo.cc.u32  %1, %4, %5, %1;\n\t"
        "madc.hi.u32     %2, %4, %5, %2;"
        : "=&r"(z), "+r"(t2), "+r"(t3)
        : "r"(t1), "r"(m), "r"(F63_K));
    return f63_sub_p(join32(t2, t3));
}

// a * b as four words (t3 t2 t1 t0); a, b < 2^63.
__device__ __forceinline__ void f63_mul_wide(u64 a, u64 b, u32& t0, u32& t1,
                                             u32& t2, u32& t3) {
    asm("mul.lo.u32      %0, %4, %6;\n\t"
        "mul.hi.u32      %1, %4, %6;\n\t"
        "mul.lo.u32      %2, %5, %7;\n\t"
        "mul.hi.u32      %3, %5, %7;\n\t"
        "mad.lo.cc.u32   %1, %4, %7, %1;\n\t"
        "madc.hi.cc.u32  %2, %4, %7, %2;\n\t"
        "addc.u32        %3, %3, 0;\n\t"
        "mad.lo.cc.u32   %1, %5, %6, %1;\n\t"
        "madc.hi.cc.u32  %2, %5, %6, %2;\n\t"
        "addc.u32        %3, %3, 0;"
        : "=&r"(t0), "=&r"(t1), "=&r"(t2), "=&r"(t3)
        : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
}

// a^2 as four words from three partial products: a0^2, a1^2 and a0 * 2a1
// (a < 2^63, so a1 < 2^31 and 2a1 fits a word).
__device__ __forceinline__ void f63_sqr_wide(u64 a, u32& t0, u32& t1,
                                             u32& t2, u32& t3) {
    asm("mul.lo.u32      %0, %4, %4;\n\t"
        "mul.hi.u32      %1, %4, %4;\n\t"
        "mul.lo.u32      %2, %5, %5;\n\t"
        "mul.hi.u32      %3, %5, %5;\n\t"
        "mad.lo.cc.u32   %1, %4, %6, %1;\n\t"
        "madc.hi.cc.u32  %2, %4, %6, %2;\n\t"
        "addc.u32        %3, %3, 0;"
        : "=&r"(t0), "=&r"(t1), "=&r"(t2), "=&r"(t3)
        : "r"(lo32(a)), "r"(hi32(a)), "r"(hi32(a) << 1));
}

// (c3 c2 c1 c0) += a * b; the caller keeps the sum below 2^128.
__device__ __forceinline__ void f63_mac(u32 c[4], u64 a, u64 b) {
    asm("mad.lo.cc.u32   %0, %4, %6, %0;\n\t"
        "madc.hi.cc.u32  %1, %4, %6, %1;\n\t"
        "madc.lo.cc.u32  %2, %5, %7, %2;\n\t"
        "madc.hi.u32     %3, %5, %7, %3;\n\t"
        "mad.lo.cc.u32   %1, %4, %7, %1;\n\t"
        "madc.hi.cc.u32  %2, %4, %7, %2;\n\t"
        "addc.u32        %3, %3, 0;\n\t"
        "mad.lo.cc.u32   %1, %5, %6, %1;\n\t"
        "madc.hi.cc.u32  %2, %5, %6, %2;\n\t"
        "addc.u32        %3, %3, 0;"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
}

// c = (c3 c2 c1 c0) < 2^128  ->  c * 2^-64 mod p, canonical: the high half
// h < 2^64 < 4p comes below p with two conditional subtractions (2p, p), so
// that c < p * 2^64, then one REDC.
__device__ __forceinline__ u64 f63_redc_wide(const u32 c[4]) {
    u64 h = join32(c[2], c[3]);
    h = h >= 2 * F63_P ? h - 2 * F63_P : h;
    h = f63_sub_p(h);
    return f63_redc(c[0], c[1], lo32(h), hi32(h));
}

// REDC(a * b) = a * b * 2^-64 mod p, canonical.
__device__ __forceinline__ u64 f63_mmul(u64 a, u64 b) {
    u32 t0, t1, t2, t3;
    f63_mul_wide(a, b, t0, t1, t2, t3);
    return f63_redc(t0, t1, t2, t3);
}

// REDC(a * a).
__device__ __forceinline__ u64 f63_msqr(u64 a) {
    u32 t0, t1, t2, t3;
    f63_sqr_wide(a, t0, t1, t2, t3);
    return f63_redc(t0, t1, t2, t3);
}

// x^INV_ALPHA, INV_ALPHA = 0b1010111 (01)x27 1: ops/kernels.py
// INV_ALPHA_CHAIN written out, 61 squarings and 12 multiplies.
__device__ __forceinline__ u64 f63_inv_sbox(u64 x) {
    u64 x2 = f63_msqr(x);
    u64 x5 = f63_mmul(f63_msqr(x2), x);
    u64 x21 = f63_mmul(f63_msqr(f63_msqr(x5)), x);
    u64 x85 = f63_mmul(f63_msqr(f63_msqr(x21)), x);
    u64 y = f63_mmul(x85, x2);  // x^87
#pragma unroll 1
    for (int i = 0; i < 6; i++) {  // y = y^(2^8) * x^85
#pragma unroll
        for (int k = 0; k < 8; k++) y = f63_msqr(y);
        y = f63_mmul(y, x85);
    }
#pragma unroll
    for (int k = 0; k < 6; k++) y = f63_msqr(y);
    return f63_mmul(f63_msqr(f63_mmul(y, x21)), x);
}
