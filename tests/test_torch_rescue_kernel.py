"""The arithmetic of the Rescue kernel (certificate_stark_tpu_torch/csrc/
f63.cuh and rescue_perm.cu), modelled in Python ints instruction for
instruction, against ops/field.mul and pow. Tolerance: exact equality.

The model runs the PTX carry chains of f63.cuh on 32-bit words with a carry
flag, and fails where an instruction without `.cc` would drop a carry: the
kernel's claim that no such carry exists is checked too. The kernel itself
runs only on the card; chip_smoke.py holds it bit for bit against the plain
version there.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops import rescue as R

P = F.P
M32 = 0xFFFFFFFF
P_K = P >> 32                                   # p = P_K * 2^32 + 1
R_INV = pow(1 << 64, -1, P)
EDGES = [0, 1, P - 1, P - 2, 1 << 32, (1 << 63) % P]


class Ptx:
    """The PTX integer instructions of f63.cuh on 32-bit words, with the
    carry flag CC.CF."""

    def __init__(self):
        self.cf = 0

    def _put(self, r, cc):
        if cc:
            self.cf = r >> 32
        else:
            assert r >> 32 == 0, "an instruction without .cc drops a carry"
        return r & M32

    def mul_lo(self, a, b):
        return (a * b) & M32

    def mul_hi(self, a, b):
        return (a * b) >> 32

    def add_cc(self, a, b):
        return self._put(a + b, True)

    def addc(self, a, b):
        return self._put(a + b + self.cf, False)

    def mad_lo_cc(self, a, b, c):
        return self._put(((a * b) & M32) + c, True)

    def madc_lo_cc(self, a, b, c):
        return self._put(((a * b) & M32) + c + self.cf, True)

    def madc_hi_cc(self, a, b, c):
        return self._put(((a * b) >> 32) + c + self.cf, True)

    def madc_hi(self, a, b, c):
        return self._put(((a * b) >> 32) + c + self.cf, False)


def sub_p(u):
    return u - P if u >= P else u


def redc(t0, t1, t2, t3):
    """f63_redc: two 32-bit steps with m = -t0 mod 2^32."""
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
    assert u < 2 * P
    return sub_p(u)


def mul_wide(a, b):
    """f63_mul_wide: four partial products."""
    x = Ptx()
    a0, a1, b0, b1 = a & M32, a >> 32, b & M32, b >> 32
    t0, t1 = x.mul_lo(a0, b0), x.mul_hi(a0, b0)
    t2, t3 = x.mul_lo(a1, b1), x.mul_hi(a1, b1)
    t1 = x.mad_lo_cc(a0, b1, t1)
    t2 = x.madc_hi_cc(a0, b1, t2)
    t3 = x.addc(t3, 0)
    t1 = x.mad_lo_cc(a1, b0, t1)
    t2 = x.madc_hi_cc(a1, b0, t2)
    t3 = x.addc(t3, 0)
    return [t0, t1, t2, t3]


def sqr_wide(a):
    """f63_sqr_wide: three partial products, a0^2, a1^2 and a0 * 2a1."""
    x = Ptx()
    a0, a1 = a & M32, a >> 32
    a1d = a1 << 1
    assert a1d <= M32
    t0, t1 = x.mul_lo(a0, a0), x.mul_hi(a0, a0)
    t2, t3 = x.mul_lo(a1, a1), x.mul_hi(a1, a1)
    t1 = x.mad_lo_cc(a0, a1d, t1)
    t2 = x.madc_hi_cc(a0, a1d, t2)
    t3 = x.addc(t3, 0)
    return [t0, t1, t2, t3]


def mac(c, a, b):
    """f63_mac: c += a * b in four words."""
    x = Ptx()
    a0, a1, b0, b1 = a & M32, a >> 32, b & M32, b >> 32
    c[0] = x.mad_lo_cc(a0, b0, c[0])
    c[1] = x.madc_hi_cc(a0, b0, c[1])
    c[2] = x.madc_lo_cc(a1, b1, c[2])
    c[3] = x.madc_hi(a1, b1, c[3])
    c[1] = x.mad_lo_cc(a0, b1, c[1])
    c[2] = x.madc_hi_cc(a0, b1, c[2])
    c[3] = x.addc(c[3], 0)
    c[1] = x.mad_lo_cc(a1, b0, c[1])
    c[2] = x.madc_hi_cc(a1, b0, c[2])
    c[3] = x.addc(c[3], 0)


def redc_wide(c):
    """f63_redc_wide: the high half below p by two conditional
    subtractions, then one REDC."""
    h = c[2] | c[3] << 32
    h = h - 2 * P if h >= 2 * P else h
    h = sub_p(h)
    return redc(c[0], c[1], h & M32, h >> 32)


def mds_row(row, lanes):
    """rescue_perm.cu mds_row: 14 unreduced products, one reduction."""
    c = mul_wide(row[0], lanes[0])
    for m, s in zip(row[1:], lanes[1:]):
        mac(c, m, s)
    assert (c[0] | c[1] << 32 | c[2] << 64 | c[3] << 96) < 1 << 128
    return redc_wide(c)


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    a = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
    b = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
    a += [x for x in EDGES for _ in EDGES]
    b += [y for _ in EDGES for y in EDGES]
    return a, b


def _field_mul(a, b):
    """ops/field.mul (its plain version on the CPU) on lists of ints."""
    out = F.mul(torch.tensor(a, dtype=torch.int64),
                torch.tensor(b, dtype=torch.int64))
    return [int(v) for v in out]


def test_word_redc_multiply_matches_field_mul():
    """f63_mmul: 10^4 random pairs and every pair of the edge values."""
    a, b = _pairs(1, 10_000)
    got = [redc(*mul_wide(x, y)) for x, y in zip(a, b)]
    assert got == _field_mul(a, b)
    assert got == [x * y * R_INV % P for x, y in zip(a, b)]


def test_word_redc_square_matches_field_mul():
    """f63_msqr, with three partial products."""
    a, _ = _pairs(2, 10_000)
    got = [redc(*sqr_wide(x)) for x in a]
    assert got == _field_mul(a, a)
    assert all(sqr_wide(x) == mul_wide(x, x) for x in a[:1000])


@pytest.mark.parametrize("case", ["worst", "random", "rescue_mds"])
def test_deferred_mds_reduction(case):
    """One reduction per MDS row equals the field sum of 14 products; the
    worst case (every entry and lane p - 1) still fits 128 bits."""
    rng = np.random.default_rng(3)
    if case == "worst":
        rows, lanes = [[P - 1] * 14], [[P - 1] * 14]
    else:
        lanes = [[int(v) for v in rng.integers(0, P, 14, dtype=np.uint64)]
                 for _ in range(200)]
        rows = ([[int(v) for v in R.MDS[i % 14]] for i in range(200)]
                if case == "rescue_mds" else
                [[int(v) for v in rng.integers(0, P, 14, dtype=np.uint64)]
                 for _ in range(200)])
    for row, s in zip(rows, lanes):
        expect = F.sum(F.mul(torch.tensor(row, dtype=torch.int64),
                             torch.tensor(s, dtype=torch.int64)))
        assert mds_row(row, s) == int(expect)
        assert mds_row(row, s) == sum(x * y for x, y in zip(row, s)) \
            * R_INV % P


def test_inv_alpha_chain_is_x_to_the_inv_alpha():
    """INV_ALPHA_CHAIN: its exponent is INV_ALPHA, in 61 squarings and 12
    multiplies (the counts chip_smoke.py's bound takes), and walked with
    ops/field.mul it equals pow on random values and the edge values."""
    assert K.walk_chain(1, lambda e: 2 * e, lambda e, f: e + f) == \
        K.INV_ALPHA
    ops = {"sqr": 0, "mul": 0}

    def count(kind):
        def op(*args):
            ops[kind] += 1
            return args[0]
        return op
    K.walk_chain(0, count("sqr"), count("mul"))
    assert (ops["sqr"], ops["mul"]) == (chip_smoke.INV_ALPHA_SQR,
                                        chip_smoke.INV_ALPHA_MUL) == (61, 12)
    rng = np.random.default_rng(4)
    xs = [int(v) for v in rng.integers(0, P, 1000, dtype=np.uint64)] + EDGES
    t = F.from_ints(xs, "cpu")
    got = F.to_ints(K.walk_chain(t, F.square, F.mul))
    assert [int(v) for v in got] == [pow(x, K.INV_ALPHA, P) for x in xs]
    # and the word-level model's square and multiply agree on the chain
    mont = [int(v) for v in t]
    model = [K.walk_chain(x, lambda r: redc(*sqr_wide(r)),
                          lambda r, s: redc(*mul_wide(r, s)))
             for x in mont[:50]]
    assert model == [int(v) for v in K.walk_chain(t[:50], F.square, F.mul)]
