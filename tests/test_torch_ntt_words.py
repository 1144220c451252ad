"""The butterflies of the ntt and lde kernels (certificate_stark_tpu_torch/
csrc/ntt.cu `dit`, `mmul_lazy`, `mmul`, `add_p`, `sub_p`), modelled in
Python ints word for word, against radix-2 stages mod p. Tolerance: exact
equality (mod p for the lazy outputs, as canonical values for the rest).

A lazy value is < 3p (< 2^64) and only ever multiplied: `dit` leaves an
output lazy where the next stage multiplies it, and multiplies whose two
outputs are both lazy skip their final subtraction. The model runs the
PTX carry chains of f63.cuh's product and REDC on the word model of
tests/test_torch_rescue_kernel.py (which fails where an instruction
without `.cc` would drop a carry) for multiplicands up to 3p, and checks
every claim the kernel's comments make: the x of a butterfly and the
operands of add_p / sub_p canonical, every multiplicand below 3p, the
lazy products below 1.77p, the lazy outputs below 3p, and the canonical
ones below p. The replay of tests/test_torch_ntt_plan.py runs the same
stages with canonical arithmetic; the kernel itself runs only on the
card, where chip_smoke.py holds it bit for bit against its plain version.
"""
import os
import random

import pytest

from test_torch_rescue_kernel import M32, P, Ptx, mul_wide

M64 = (1 << 64) - 1
P_K = P >> 32
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "certificate_stark_tpu_torch", "csrc", "ntt.cu")


def mmul_lazy(a, b):
    """ntt.cu `mmul_lazy`: f63_mul_wide, then f63_redc's two steps with no
    final subtraction."""
    assert a < 3 * P and b < P
    t0, t1, t2, t3 = mul_wide(a, b)
    x = Ptx()
    m = (-t0) & M32
    x.add_cc(t0, m)
    t1 = x.madc_lo_cc(m, P_K, t1)
    t2 = x.madc_hi_cc(m, P_K, t2)
    t3 = x.addc(t3, 0)
    m = (-t1) & M32
    x.add_cc(t1, m)
    t2 = x.madc_lo_cc(m, P_K, t2)
    t3 = x.madc_hi(m, P_K, t3)
    u = t2 | t3 << 32
    assert u * 100 < 177 * P            # < 1.77 p
    assert u % P == a * b * pow(1 << 64, -1, P) % P
    return u


def _signed(x):
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def _tail(s):
    """The signed tail: s in [-p, p), plus p where negative."""
    assert -P <= s < P
    return s + P if s < 0 else s


def mmul(a, b):
    return _tail(_signed(mmul_lazy(a, b) - P))


def add_p(a, b):
    assert a < P and b < P
    return _tail(_signed(a + b - P))


def sub_p(a, b):
    assert a < P and b < P
    return _tail(_signed(a - b))


def dit(v, k, first, lazy_out, w, s, lo):
    """ntt.cu `dit` on the unit's registers v (Montgomery patterns)."""
    for t in range(k):
        for m in range(1 << k):
            if m & (1 << t):
                continue
            ml, mh = m & ((1 << t) - 1), m | (1 << t)
            next_y = (m >> (t + 1)) & 1 if t + 1 < k else lazy_out
            lazy_x = next_y and (t + 1 == k or not first or ml != 0)
            lazy_y = next_y
            y = v[mh]
            if not first or ml:
                wv = w[(1 << t) - 1 + ml] if first \
                    else w[((((1 << t) - 1 + ml)) << s) + lo]
                y = mmul_lazy(y, wv) if lazy_x else mmul(y, wv)
            else:
                assert y < P                # w^0 = 1: y is used as it is
            x = v[m]
            assert x < P
            v[m] = (x + y) & M64 if lazy_x else add_p(x, y)
            v[mh] = (x + 2 * P - y) & M64 if lazy_y else sub_p(x, y)
            for o, lz in ((m, lazy_x), (mh, lazy_y)):
                assert v[o] < (3 * P if lz else P)


def _stages(v, k, w, s, lo):
    """The same stages mod p on Montgomery patterns, canonical: the
    radix-2 butterflies of the replay."""
    r_inv = pow(1 << 64, -1, P)
    v = [x % P for x in v]
    for t in range(k):
        for m in range(1 << k):
            if m & (1 << t):
                continue
            ml, mh = m & ((1 << t) - 1), m | (1 << t)
            wv = w[((((1 << t) - 1 + ml)) << s) + lo]
            y = v[mh] * wv * r_inv % P
            v[m], v[mh] = (v[m] + y) % P, (v[m] - y) % P
    return v


ONE = (1 << 64) % P        # Montgomery 1


def _table(rng, k, s, first, edge):
    n = (((1 << k) - 1) << s) + (1 << s)
    w = [P - 1 if edge else rng.randrange(P) for _ in range(n)]
    if first:   # the first round's stage t twiddle of ml = 0 is 1
        for t in range(k):
            w[(1 << t) - 1] = ONE
    return w


@pytest.mark.parametrize("lazy_out", [False, True])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_lazy_butterflies_match_radix2_stages(k, first, lazy_out):
    """Random and all-(p - 1) units and twiddles, and units of the largest
    lazy values a stage can see (3p - 1 multiplicands through the store's
    multiply where lazy_out): outputs congruent to the canonical stages,
    canonical where the round's outputs are stored as they are."""
    rng = random.Random(k * 4 + first * 2 + lazy_out)
    s = 0 if first else 2
    for trial in range(40):
        edge = trial < 2
        w = _table(rng, k, s, first, edge)
        lo = 0 if first else rng.randrange(1 << s)
        v = [P - 1 if edge or trial == 2 else rng.randrange(P)
             for _ in range(1 << k)]
        exp = _stages(v, k, w, s, lo)
        got = list(v)
        dit(got, k, first, lazy_out, w, s, lo)
        assert [x % P for x in got] == exp
        if lazy_out:    # the store multiplies each output, canonical
            tw = P - 1 if edge else rng.randrange(P)
            assert [mmul(x, tw) for x in got] == \
                [x * tw * pow(1 << 64, -1, P) % P for x in exp]
        else:
            assert got == exp


def test_multiplies_of_the_largest_lazy_values():
    """mmul_lazy and mmul at multiplicands 3p - 1 .. 3p - 8 and p - 1 .. 0
    against twiddles p - 1, 1 and Montgomery one."""
    for a in [3 * P - 1 - i for i in range(8)] + [P - 1, 2 * P, 0, 1]:
        for b in (P - 1, 1, ONE, P // 2):
            exp = a * b * pow(1 << 64, -1, P) % P
            assert mmul(a, b) == exp
            assert mmul_lazy(a, b) % P == exp


def test_model_follows_source():
    """The lines of ntt.cu that the model replays."""
    src = open(SRC).read()
    for line in (
            "const bool next_y = t + 1 < K ? (m >> (t + 1)) & 1 : LAZY_OUT;",
            "const bool lazy_x = next_y && (t + 1 == K || !FIRST || ml != 0);",
            "const bool lazy_y = next_y;",
            "y = lazy_x ? mmul_lazy(y, wv) : mmul(y, wv);",
            "v[m] = lazy_x ? x + y : add_p(x, y);",
            "v[mh] = lazy_y ? x + 2 * F63_P - y : sub_p(x, y);",
            "long long s = (long long)(a + b - F63_P);",
            "long long d = (long long)(a - b);",
            "long long s = (long long)(mmul_lazy(a, b) - F63_P);",
            "return a.p != a.P - 1 || a.scale != 0;"):
        assert line in src, line
