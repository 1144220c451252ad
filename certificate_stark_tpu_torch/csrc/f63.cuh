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

// 2^64 mod p: one in Montgomery form
#define F63_ONE 4287426845256712189ULL

// a - b for canonical a, b: the difference wraps below 0 exactly when it
// must take p back, and then lies above 2^64 - p > 2^63, so its sign bit
// chooses.
__device__ __forceinline__ u64 msub(u64 a, u64 b) {
    const u64 d = a - b;
    return (long long)d < 0 ? d + F63_P : d;
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

// ---- unreduced sums of products (compose.cu, deep.cu) --------------------
// A sum of products of canonical values is kept in 128 bits and reduced
// once: in Montgomery form the REDC of a sum is the sum of the REDCs mod
// p. tests/test_torch_compose_words.py replays these helpers in Python ints
// and checks the bounds below.
#define FOLD_EVERY 7          // products between two folds of a sum
#define FOLD_TOP 0x83000000u  // the high word after a fold: (2p) >> 96
#define MAX_TERMS (1 << 26)   // products in one sum, for o 2^32's room

// An unreduced sum of products of canonical values, in two parts:
//   e = eh 2^64 + el   sum of a0 b0 + a1 b1 2^64, each term <= (p - 1)^2
//   o = oh 2^64 + ol   sum of a0 b1 + a1 b0, each term < 2^64
// of a = a1 2^32 + a0, b = b1 2^32 + b0; the sum is e + o 2^32. Each
// 64-bit half is one operand of a 32 x 32 + 64-bit multiply-add, so it
// stays in one aligned register pair (a sum in four words that adds the
// cross products at word 1 makes the compiler move words between pairs
// for every product).
struct Wide {
    u64 el, eh, ol;
    u32 oh;
};

__device__ __forceinline__ void wide_zero(Wide& w) {
    w.el = w.eh = w.ol = 0;
    w.oh = 0;
}

// w += a * b: two multiply-adds into e (a carry between its halves), two
// into ol (each carry into oh); the caller keeps e below 2^128 by folds
// and o below 2^96 by the count of terms.
__device__ __forceinline__ void wide_mac(Wide& w, u64 a, u64 b) {
    asm("{\n\t.reg .u32 e0, e1, e2, e3, o0, o1;\n\t"
        "mov.b64         {e0, e1}, %0;\n\t"
        "mov.b64         {e2, e3}, %1;\n\t"
        "mov.b64         {o0, o1}, %2;\n\t"
        "mad.lo.cc.u32   e0, %4, %6, e0;\n\t"
        "madc.hi.cc.u32  e1, %4, %6, e1;\n\t"
        "madc.lo.cc.u32  e2, %5, %7, e2;\n\t"
        "madc.hi.u32     e3, %5, %7, e3;\n\t"
        "mad.lo.cc.u32   o0, %4, %7, o0;\n\t"
        "madc.hi.cc.u32  o1, %4, %7, o1;\n\t"
        "addc.u32        %3, %3, 0;\n\t"
        "mad.lo.cc.u32   o0, %5, %6, o0;\n\t"
        "madc.hi.cc.u32  o1, %5, %6, o1;\n\t"
        "addc.u32        %3, %3, 0;\n\t"
        "mov.b64         %0, {e0, e1};\n\t"
        "mov.b64         %1, {e2, e3};\n\t"
        "mov.b64         %2, {o0, o1};\n\t}"
        : "+l"(w.el), "+l"(w.eh), "+l"(w.ol), "+r"(w.oh)
        : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
}

// eh less 2p where e's high word exceeds FOLD_TOP (then e >= (FOLD_TOP +
// 1) 2^96 > 2p 2^64): the same value mod p, with a high word of at most
// FOLD_TOP either way.
__device__ __forceinline__ void wide_fold(Wide& w) {
    if (hi32(w.eh) > FOLD_TOP) w.eh -= 2 * F63_P;
}

// The sum's value e + o 2^32 (below 2^128: e is below (FOLD_TOP + 1)
// 2^96 + FOLD_EVERY (p - 1)^2 and o 2^32 below 2^96 times the terms),
// reduced: sum * 2^-64 mod p, canonical.
__device__ __forceinline__ u64 wide_redc(const Wide& w) {
    u32 c[4] = {lo32(w.el), hi32(w.el), lo32(w.eh), hi32(w.eh)};
    asm("add.cc.u32      %0, %0, %3;\n\t"
        "addc.cc.u32     %1, %1, %4;\n\t"
        "addc.u32        %2, %2, %5;"
        : "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(lo32(w.ol)), "r"(hi32(w.ol)), "r"(w.oh));
    return f63_redc_wide(c);
}
