"""The accumulation of the compose kernel (certificate_stark_tpu_torch/csrc/
compose.cu), modelled in Python ints word for word, against the wrapper's
plain version `compose_plain`. Tolerance: exact equality.

The model replays one point of `compose_pair`: each base value times
extension coordinate summed unreduced into a `Wide` sum (e: the products
of the low words and of the high words; o: the cross products) by the
PTX of wide_mac, a fold of e after every FOLD_EVERY items of a group and
after each group's x^adj product (both read from the source), a group's
beta sum reduced once and its x^adj product added into the alpha sum,
the zerofier's and divisors' products as single Montgomery multiplies.
The PTX carry chains run on the word model of
tests/test_torch_rescue_kernel.py, which fails where an instruction
without `.cc` would drop a carry; every sum is also checked below 2^128
before each product and each reduction. The kernel itself runs only on
the card: chip_smoke.py holds it bit for bit against its plain version
there, on the same worst case too.
"""
import os
import re

import numpy as np
import pytest
import torch

from certificate_stark_tpu_torch.ops import kernels as K
from test_torch_rescue_kernel import (M32, P, Ptx, mul_wide, redc,
                                      redc_wide)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "certificate_stark_tpu_torch", "csrc")
# the kernel and f63.cuh, which holds its unreduced sums (Wide, wide_mac,
# the fold constants) since deep.cu shares them
_TEXT = "".join(open(os.path.join(CSRC, f)).read()
                for f in ("compose.cu", "f63.cuh"))
FOLD_EVERY = int(re.search(r"#define FOLD_EVERY (\d+)", _TEXT).group(1))
FOLD_TOP = int(re.search(r"#define FOLD_TOP (0x[0-9a-fA-F]+)u", _TEXT)
               .group(1), 16)
MAX_TERMS = 1 << int(re.search(r"#define MAX_TERMS \(1 << (\d+)\)", _TEXT)
                        .group(1))
CAP = 1 << 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs a worker process per core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Ptx2(Ptx):
    """The word model's instructions, with the carry-in, carry-out add
    that compose.cu uses besides them."""

    def addc_cc(self, a, b):
        return self._put(a + b + self.cf, True)


class Wide:
    """compose.cu `Wide`: e (four words) sums a0 b0 + a1 b1 2^64, o (three
    words) sums a0 b1 + a1 b0; the sum is e + o 2^32."""

    def __init__(self):
        self.e, self.o = [0] * 4, [0] * 3

    def value(self):
        e, o = self.e, self.o
        return (e[0] | e[1] << 32 | e[2] << 64 | e[3] << 96) + \
            ((o[0] | o[1] << 32 | o[2] << 64) << 32)


def wide_mac(w, a, b, x=None):
    """wide_mac, instruction for instruction."""
    x = x or Ptx2()
    a0, a1, b0, b1 = a & M32, a >> 32, b & M32, b >> 32
    e, o = w.e, w.o
    e[0] = x.mad_lo_cc(a0, b0, e[0])
    e[1] = x.madc_hi_cc(a0, b0, e[1])
    e[2] = x.madc_lo_cc(a1, b1, e[2])
    e[3] = x.madc_hi(a1, b1, e[3])
    o[0] = x.mad_lo_cc(a0, b1, o[0])
    o[1] = x.madc_hi_cc(a0, b1, o[1])
    o[2] = x.addc(o[2], 0)
    o[0] = x.mad_lo_cc(a1, b0, o[0])
    o[1] = x.madc_hi_cc(a1, b0, o[1])
    o[2] = x.addc(o[2], 0)


def fold(w):
    """wide_fold: e's high half less 2p where its high word exceeds
    FOLD_TOP (a 64-bit subtraction that must not borrow)."""
    if w.e[3] > FOLD_TOP:
        h = (w.e[2] | w.e[3] << 32) - 2 * P
        assert h >= 0
        w.e[2], w.e[3] = h & M32, h >> 32
    assert w.e[3] <= FOLD_TOP


def wide_redc(w):
    """wide_redc: e + o 2^32 in four words, then f63_redc_wide."""
    x = Ptx2()
    c = list(w.e)
    c[1] = x.add_cc(c[1], w.o[0])
    c[2] = x.addc_cc(c[2], w.o[1])
    c[3] = x.addc(c[3], w.o[2])
    assert c[0] | c[1] << 32 | c[2] << 64 | c[3] << 96 == w.value()
    return redc_wide(c)


class Sums:
    """The kernel's sums of one point, with the largest value any of them
    reached before a product or a reduction."""

    def __init__(self):
        self.peak = 0

    def seen(self, w):
        v = w.value()
        assert v < CAP, "a sum outgrew its four words"
        self.peak = max(self.peak, v)

    def mac(self, w, a, b):
        assert a < P and b < P
        wide_mac(w, a, b)
        self.seen(w)

    def redc_wide(self, w):
        self.seen(w)
        return wide_redc(w)


def mmul(a, b):
    return redc(*mul_wide(a, b))


def add(a, b):
    s = a + b
    return s - P if s >= P else s


def msub(a, b):
    return a - b if a >= b else a + (P - b)


def compose_point(sums, tabs, i, j, ev, cu, co):
    """One point of compose_pair on Montgomery patterns: evals [C][S] and
    cur [w][S] at point i, the domain tables at point j; co the
    coefficient lists t_alpha, t_beta, b_alpha, b_beta [d][.]. -> [d].
    Each group's items go FOLD_EVERY at a time, both sums folded after
    each such run; then the rest and the x^adj product."""
    ta, tb, ba, bb = co
    d = len(ta)
    xpow, zt_inv, b_invz, b_ev = (tabs.xpow.tolist(), tabs.zt_inv.tolist(),
                                  tabs.b_invz.tolist(), tabs.b_ev.tolist())

    def runs(start, end):
        """The kernel's items start .. end - 1, each with whether both sums
        are folded after it."""
        full = start + (end - start) // FOLD_EVERY * FOLD_EVERY
        return [(k, k < full and (k - start) % FOLD_EVERY == FOLD_EVERY - 1)
                for k in range(start, end)]

    def fold_all(*groups):
        for g in groups:
            for w in g:
                fold(w)

    sa = [Wide() for _ in range(d)]
    for g, row in enumerate(tabs.t_row):
        sb = [Wide() for _ in range(d)]
        for k, then_fold in runs(tabs.t_start[g], tabs.t_start[g + 1]):
            c = tabs.t_idx[k]
            for e in range(d):
                sums.mac(sa[e], ev[c][i], ta[e][c])
                sums.mac(sb[e], ev[c][i], tb[e][c])
            if then_fold:
                fold_all(sa, sb)
        for e in range(d):
            sums.mac(sa[e], sums.redc_wide(sb[e]), xpow[row][j])
        fold_all(sa)
    acc = [mmul(sums.redc_wide(sa[e]), zt_inv[j]) for e in range(d)]
    for g, row in enumerate(tabs.b_adj):
        sa = [Wide() for _ in range(d)]
        sb = [Wide() for _ in range(d)]
        for a, then_fold in runs(tabs.b_start[g], tabs.b_start[g + 1]):
            r = tabs.b_row[a]
            bev = tabs.b_val[a] if r < 0 else b_ev[r][j]
            num = msub(cu[tabs.b_col[a]][i], bev)
            q = tabs.b_coef[a]
            for e in range(d):
                sums.mac(sa[e], num, ba[e][q])
                sums.mac(sb[e], num, bb[e][q])
            if then_fold:
                fold_all(sa, sb)
        for e in range(d):
            sums.mac(sa[e], sums.redc_wide(sb[e]), xpow[row][j])
            acc[e] = add(acc[e], mmul(sums.redc_wide(sa[e]), b_invz[g][j]))
    return acc


def _tables(rng, count, C, t_sizes, b_sizes, w, fill=None):
    """ComposeTables on `count` points: C constraints in groups of t_sizes
    (shuffled), boundary groups of b_sizes over w trace columns, half of
    their assertions with a constant value and half with a b_ev row; every
    table value random, or `fill`."""
    def vals(*shape):
        if fill is not None:
            return torch.full(shape, fill, dtype=torch.int64)
        return torch.from_numpy(rng.integers(0, P, size=shape,
                                             dtype=np.uint64).astype(np.int64))
    A = len(t_sizes) + len(b_sizes)
    order = rng.permutation(C).tolist()
    t_groups, k = [], 0
    for g, n in enumerate(t_sizes):
        t_groups.append((g, order[k:k + n]))
        k += n
    assert k == C
    b_groups, coef, rows = [], 0, 0
    for g, n in enumerate(b_sizes):
        members = []
        for m in range(n):
            col = int(rng.integers(0, w))
            if m % 2 or fill is not None:
                members.append((col, coef, -1, 0 if fill is not None else
                                int(rng.integers(0, P))))
            else:
                members.append((col, coef, rows, 0))
                rows += 1
            coef += 1
        b_groups.append((len(t_sizes) + g, members))
    b_ev = vals(rows, count) if fill is None else torch.zeros(
        (rows, count), dtype=torch.int64)
    tabs = K.compose_tables(vals(A, count), vals(count),
                            vals(len(b_sizes), count), b_ev, t_groups,
                            b_groups)
    return tabs, coef


def _check(tabs, evals, cur, j0, co):
    """The model at every point against compose_plain, on the Montgomery
    patterns the kernel reads; -> the largest sum any point reached."""
    exp = K.compose_plain(evals, cur, j0, tabs, *co).tolist()
    ev, cu, cos = evals.tolist(), cur.tolist(), [c.tolist() for c in co]
    sums = Sums()
    for i in range(evals.shape[-1]):
        out = compose_point(sums, tabs, i, j0 + i, ev, cu, cos)
        assert out == [row[i] for row in exp]
    return sums.peak


class Traced(Ptx2):
    """Ptx2 that records the mnemonic of each instruction it runs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __getattribute__(self, name):
        attr = object.__getattribute__(self, name)
        if callable(attr) and name[0] != "_":
            object.__getattribute__(self, "ops").append(
                name.replace("_", ".") + ".u32")
        return attr


def test_model_follows_source():
    """wide_mac's model runs the PTX instructions of compose.cu's
    wide_mac, in its order."""
    body = _TEXT[_TEXT.index("void wide_mac("):_TEXT.index("void wide_fold(")]
    src = re.findall(r'"((?:mad|madc|addc)\.[\w.]+)\s', body)
    x = Traced()
    wide_mac(Wide(), P - 1, P - 2, x)
    assert x.ops == src and len(src) == 10


def test_fold_bound():
    """15 products of canonical values fit four words and 16 do not; a
    fold leaves e's high word at most FOLD_TOP, only ever subtracting
    2p 2^64 from a larger value, and FOLD_EVERY products fit after it,
    with room for o 2^32 of up to MAX_TERMS products."""
    big = (P - 1) ** 2
    assert 15 * big < CAP <= 16 * big
    assert (FOLD_TOP + 1) << 32 > 2 * P            # the subtraction is safe
    assert (M32 << 32 | M32) - 2 * P >> 32 <= FOLD_TOP
    assert ((FOLD_TOP + 1) << 96) + FOLD_EVERY * big < CAP
    assert ((FOLD_TOP + 1) << 96) + (FOLD_EVERY + 1) * big >= CAP
    # e's term a0 b0 + a1 b1 2^64 is at most (p - 1)^2: a word a1 of a
    # canonical a is at most top, and where it is top, a0 is 0
    top = (P - 1) >> 32
    assert (P - 1) & M32 == 0 and top ** 2 << 64 == big
    assert ((top - 1) ** 2 << 64) + M32 ** 2 < big
    # o's terms a0 b1 + a1 b0 are below 2^64, so MAX_TERMS of them, times
    # 2^32, fit beside e's largest value
    assert 2 * M32 * top < 1 << 64
    assert ((FOLD_TOP + 1) << 96) + FOLD_EVERY * big + (MAX_TERMS << 96) \
        < CAP


@pytest.mark.parametrize("d", [1, 2, 3])
def test_model_matches_plain(d):
    """115 constraints in five adjustment groups (one above FOLD_EVERY
    several times, one of a single constraint), boundary groups of 9 and 3
    assertions (constant and varying values), four points from j0 = 5 of
    a 16-point domain: the model equals compose_plain."""
    rng = np.random.default_rng(40 + d)
    count, S, j0, C, w = 16, 4, 5, 115, 6
    tabs, NB = _tables(rng, count, C, (60, 31, 15, 8, 1), (9, 3), w)
    evals = torch.from_numpy(rng.integers(0, P, size=(C, S), dtype=np.uint64)
                             .astype(np.int64))
    cur = torch.from_numpy(rng.integers(0, P, size=(w, S), dtype=np.uint64)
                           .astype(np.int64))
    co = [torch.from_numpy(rng.integers(0, P, size=(d, n), dtype=np.uint64)
                           .astype(np.int64)) for n in (C, C, NB, NB)]
    assert _check(tabs, evals, cur, j0, co) < CAP


@pytest.mark.parametrize("d", [1, 2, 3])
def test_worst_case(d):
    """Every evaluation, coefficient, trace and table value p - 1 (the
    boundary values 0, so each numerator is p - 1), all 115 constraints in
    one adjustment group, and 16 assertions in one boundary group: every
    product is (p - 1)^2, the sums come closest to 2^128, and the model
    still equals compose_plain."""
    rng = np.random.default_rng(7)
    count, S, C, w = 4, 2, 115, 3
    tabs, NB = _tables(rng, count, C, (C,), (16,), w, fill=P - 1)
    full = lambda *shape: torch.full(shape, P - 1, dtype=torch.int64)
    co = [full(d, n) for n in (C, C, NB, NB)]
    peak = _check(tabs, full(C, S), full(w, S), 1, co)
    assert CAP * 7 // 8 < peak < CAP
