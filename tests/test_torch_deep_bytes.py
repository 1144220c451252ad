"""The byte-sliced sums of the ood and deep kernels (certificate_stark_tpu_
torch/csrc/deep.cu) on the int8 tensor cores, modelled in numpy and Python
ints fragment for fragment, against the exact sums reduced as wide_redc
reduces them and against the wrappers' plain versions `deep_plain` and
`ood_plain`. Tolerance: exact equality.

The model follows the kernels step by step: each 64-bit value cut into
its bytes (the 4 x 4 byte transposes of `bytes4x4`, with the prmt
selectors read from the source); the operands laid into the
mma.m16n8k32 u8 fragments (A: lane (g, t) holds rows g and g + 8 at K
4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3; B: column g at the same K; C:
rows g, g + 8 at columns 2t, 2t + 1), each s32 accumulator checked below
2^31 after every product; a lane's share X_t recombined and checked
against its bounds; the quad's shares added exactly in the two exchanges
of `quad_sums`, on 64-bit words with their carries, the bits above 2^126
folded back and the sum reduced by the word model of f63_redc
(tests/test_torch_rescue_kernel.py). Every sum is checked against the
exact integer sum_K u_K v_K (the recombination into V) and against the
same sum reduced through the Wide word model of
tests/test_torch_compose_words.py. The constants (OOD_STRIP,
MAX_U8_TERMS, DEEP_MAX_W, DEEP_MAX_K, DEEP_ROW, the run length, 2^126 mod
p) are read from deep.cu. The kernels themselves run only on the card:
chip_smoke.py holds them bit for bit against their plain versions there,
on the worst case and the widest shape too.
"""
import os
import re

import numpy as np
import pytest
import torch

from certificate_stark_tpu_torch.ops import kernels as K
from test_torch_compose_words import FOLD_EVERY, Wide, fold, wide_mac, \
    wide_redc
from test_torch_rescue_kernel import M32, P, mul_wide, redc

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "certificate_stark_tpu_torch", "csrc")
SRC = open(os.path.join(CSRC, "deep.cu")).read()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


MAX_U8_TERMS = _define("MAX_U8_TERMS")
OOD_STRIP = _define("OOD_STRIP")
DEEP_MAX_W, DEEP_MAX_K = _define("DEEP_MAX_W"), _define("DEEP_MAX_K")
DEEP_ROW = _define("DEEP_ROW")
_RUN = re.search(r"R = D == (\d) \? (\d+) : (\d+);", SRC).groups()
RUN = {d: int(_RUN[1]) if d == int(_RUN[0]) else int(_RUN[2])
       for d in (1, 2, 3)}
C126 = int(re.search(r"#define F63_C126 (\d+)ULL", SRC).group(1))
_T4 = SRC[SRC.index("void bytes4x4"):][:800]
PERMS = [int(v, 16) for v in re.findall(
    r"__byte_perm\(\w+, \w+, (0x[0-9a-f]+)\)", _T4)]
R_INV = pow(1 << 64, -1, P)
M64 = (1 << 64) - 1
# a canonical value with the most bytes at 0xFF
BYTES_MAX = 0x40FFFFFFFFFFFFFF


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs a worker process per core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- field helpers on Montgomery patterns (word model) ---------------------
def mmul(a, b):
    return redc(*mul_wide(a, b))


def add(a, b):
    s = a + b
    return s - P if s >= P else s


def msub(a, b):
    return a - b if a >= b else a + (P - b)


def mont(x):
    return (x << 64) % P


ONE = mont(1)


def ext_mul(a, b):
    """Extension product of Montgomery coordinate lists (x^2 = 3; x^3 =
    3x + 1), each coefficient sum as exact ints then one REDC."""
    d = len(a)
    r = [0] * (2 * d - 1)
    for i in range(d):
        for j in range(d):
            r[i + j] += a[i] * b[j]
    r = [v * R_INV % P for v in r]
    three = lambda v: 3 * v % P     # noqa: E731
    if d == 1:
        return r
    if d == 2:
        return [(r[0] + three(r[2])) % P, r[1]]
    return [(r[0] + r[3]) % P, (r[1] + three(r[3]) + r[4]) % P,
            (r[2] + three(r[4])) % P]


def adj_norm(a):
    """deep.cu ext_adj_norm: the adjugate and norm of a (d = 2, 3)."""
    if len(a) == 2:
        return ([a[0], msub(0, a[1])],
                msub(mmul(a[0], a[0]), 3 * mmul(a[1], a[1]) % P))
    a0, a1, a2 = a
    m11 = (a0 + 3 * a2) % P
    m23 = (a2 + 3 * a1) % P
    adj = [msub(mmul(m11, m11), mmul(m23, a1)),
           msub(mmul(m23, a2), mmul(a1, m11)),
           msub(mmul(a1, a1), mmul(m11, a2))]
    return adj, (mmul(a0, adj[0]) + mmul(a2, adj[1]) + mmul(a1, adj[2])) % P


def combine(r):
    """deep.cu ext_combine on reduced coefficient sums."""
    d = (len(r) + 1) // 2
    if d == 1:
        return r
    if d == 2:
        return [(r[0] + 3 * r[2]) % P, r[1]]
    return [(r[0] + r[3]) % P, (r[1] + 3 * r[3] + r[4]) % P,
            (r[2] + 3 * r[4]) % P]


# ---- the fragments ---------------------------------------------------------
def byte_perm(x, y, s):
    v = x | y << 32
    return sum(((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def bytes4x4(x0, x1, x2, x3):
    """deep.cu bytes4x4 with the source's selectors."""
    s = PERMS
    t0, t1 = byte_perm(x0, x1, s[0]), byte_perm(x0, x1, s[1])
    t2, t3 = byte_perm(x2, x3, s[2]), byte_perm(x2, x3, s[3])
    return [byte_perm(t0, t2, s[4]), byte_perm(t0, t2, s[5]),
            byte_perm(t1, t3, s[6]), byte_perm(t1, t3, s[7])]


def a_frags(v):
    """deep.cu a_frags: A[u] = the four registers of m-tile u."""
    l0 = bytes4x4(*(x & M32 for x in v[:4]))
    h0 = bytes4x4(*(x >> 32 for x in v[:4]))
    l1 = bytes4x4(*(x & M32 for x in v[4:]))
    h1 = bytes4x4(*(x >> 32 for x in v[4:]))
    return [[l0[0], l0[1], l1[0], l1[1]], [l0[2], l0[3], l1[2], l1[3]],
            [h0[0], h0[1], h1[0], h1[1]], [h0[2], h0[3], h1[2], h1[3]]]


def bytes8x8(x):
    """deep.cu bytes8x8: o[g] has byte g of x[m] at byte m."""
    a = bytes4x4(*(v & M32 for v in x[:4]))
    b = bytes4x4(*(v & M32 for v in x[4:]))
    c = bytes4x4(*(v >> 32 for v in x[:4]))
    d = bytes4x4(*(v >> 32 for v in x[4:]))
    return [a[g] | b[g] << 32 for g in range(4)] + \
        [c[g] | d[g] << 32 for g in range(4)]


LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
_ROW, _K = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
A_LANE, A_REG, A_BYTE = (4 * (_ROW % 8) + (_K % 16) // 4,
                         (_ROW >= 8) + 2 * (_K >= 16), _K % 4)
_KB, _COL = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
B_LANE, B_BYTE = 4 * _COL + (_KB % 16) // 4, 4 * (_KB >= 16) + _KB % 4
C_ROW = G[:, None] + 8 * (np.arange(4)[None] >= 2)
C_COL = 2 * T[:, None] + (np.arange(4)[None] & 1)


def _bytes(words, n):
    """[..., n bytes] of integer words (object or uint64 arrays)."""
    w = np.asarray(words, dtype=np.uint64)
    return ((w[..., None] >> (8 * np.arange(n, dtype=np.uint64)))
            & np.uint64(0xFF)).astype(np.int64)


def mma(c, a, b):
    """c [32, 4] += the m16n8k32 u8 product of the warp's A registers a
    [32, 4] and B words b [32] (low word K 4t.., high word 16 + 4t..),
    by the PTX fragment layout; every s32 sum checked below 2^31."""
    am = _bytes(a, 4)[A_LANE, A_REG, A_BYTE]          # [16, 32]
    bm = _bytes(b, 8)[B_LANE, B_BYTE]                 # [32, 8]
    c += (am @ bm)[C_ROW, C_COL]
    assert int(c.max()) < 1 << 31 and int(c.min()) >= 0
    return c


def share_x(acc):
    """deep.cu share_x(): a lane's exact X_t from its four m-tiles' C
    (acc[u] = [c0, c1, c2, c3]) as (low 64 bits, the bits above), with
    its bounds."""
    assert all(0 <= v < 1 << 31 for c in acc for v in c)
    assert all(c[1] + c[2] < 1 << 32 for c in acc)
    ys = [c[0] + ((c[1] + c[2]) << 8) + (c[3] << 16) for c in acc]
    assert all(y < 66049 << 31 for y in ys)
    lo, hi = ys[0] + (ys[1] << 16), ys[2] + (ys[3] << 16)
    assert lo <= M64 and hi <= M64
    xl = (lo + (hi << 32)) & M64
    xh = (hi >> 32) + (xl < lo)
    assert xh <= M32 and xl | xh << 64 == lo + (hi << 32) < 1 << 96
    return xl, xh


def quad_sums(acc, n_sums):
    """deep.cu quad_sums() over the warp: acc[lane][n][u] = C of m-tile u
    of n-tile n. Every lane's shares, the two exchanges (t ^ 1: Y =
    X_even + 2^16 X_odd; t ^ 2: V = Y_01 + 2^32 Y_23) on 64-bit words with
    their carries as the source takes them, the fold of V's bits from
    2^126 and one REDC -> (exact[g][n], reduced[g][n]) of point g, each
    word and bound checked; lane (g, t) ends with sum 4j + t."""
    Q = -(-n_sums // 4)
    x = [[share_x(acc[lane][n]) if n < n_sums else (0, 0)
          for n in range(4 * Q)] for lane in range(32)]
    y = [[None] * (2 * Q) for _ in range(32)]
    for lane in range(32):
        odd = lane & 1
        for i in range(2 * Q):
            own = x[lane][2 * i + odd]
            rcv = x[lane ^ 1][2 * i + odd]      # the partner's sent share
            (el, eh), (dl, dh) = (rcv, own) if odd else (own, rcv)
            yl = (el + (dl << 16)) & M64
            yh = eh + (dh << 16) + (dl >> 48) + (yl < el)
            assert yh < 1 << 48
            assert yl | yh << 64 == (el | eh << 64) + ((dl | dh << 64) << 16)
            y[lane][i] = (yl, yh)
    exact = [[0] * n_sums for _ in range(8)]
    red = [[0] * n_sums for _ in range(8)]
    for lane in range(32):
        g, t, up = lane >> 2, lane & 3, (lane >> 1) & 1
        for j in range(Q):
            own, rcv = y[lane][2 * j + up], y[lane ^ 2][2 * j + up]
            (ll, lh), (hl, hh) = (rcv, own) if up else (own, rcv)
            z0 = (ll + (hl << 32)) & M64
            tz = lh + (hl >> 32) + (z0 < ll)
            assert tz <= M64
            z1 = (tz + (hh << 32)) & M64
            z2 = (hh >> 32) + (z1 < tz)
            v = z0 | z1 << 64 | z2 << 128
            assert v == (ll | lh << 64) + ((hl | hh << 64) << 32) < 1 << 144
            top = (z2 << 2) | (z1 >> 62)
            assert top < 1 << 18 and top * C126 < 1 << 81
            w0 = (z0 + top * C126) & M64
            w1 = (z1 & ((1 << 62) - 1)) + (top * C126 >> 64) + (w0 < z0)
            assert w0 | w1 << 64 == v % (1 << 126) + top * C126 < P << 64
            n = 4 * j + t
            if n < n_sums:
                exact[g][n] = v
                red[g][n] = redc(w0 & M32, w0 >> 32, w1 & M32, w1 >> 32)
    return exact, red


def wide_sum(us, vs):
    """sum_K u_K v_K through the Wide word model (a fold every FOLD_EVERY
    products), reduced by wide_redc."""
    w = Wide()
    for i, (u, v) in enumerate(zip(us, vs)):
        wide_mac(w, u, v)
        if i % FOLD_EVERY == FOLD_EVERY - 1:
            fold(w)
    return wide_redc(w)


def run_tiles(chunks, bfrag, nt):
    """A group's byte-sliced products: chunks[kappa] = [32 lanes][8
    values at the K slots], bfrag(kappa, n) = [32] B words -> acc[lane]
    [n][u] = [c0..c3]."""
    acc = np.zeros((nt, 4, 32, 4), dtype=np.int64)
    for kappa, vals in enumerate(chunks):
        frags = [a_frags(v) for v in vals]            # [lane][u][reg]
        for n in range(nt):
            b = bfrag(kappa, n)
            for u in range(4):
                mma(acc[n, u], [f[u] for f in frags], b)
    return [[[[int(v) for v in acc[n, u, lane]] for u in range(4)]
             for n in range(nt)] for lane in range(32)]


# ---- deep ------------------------------------------------------------------
def deep_row_of(m, t):
    """The chunk row that lane t's K slot m reads (the bank rotation)."""
    return 8 * t + ((m + 2 * t) & 7)


def deep_group_sums(rng, f_rows, g_cols, comp, d, k, wide=False):
    """One deep group of 8 points: f_rows [R][8] the staged rows (trace
    columns, or composition rows (e2, c) = (rc // k, rc % k)), g_cols the
    coefficients ([2d][w] for the trace: n-tile q d + e; [d][k] g_h for
    the composition: n-tile e1 + e2). Pad rows hold random bytes (stale
    shared memory): their coefficients are 0. -> [n-tile][point] reduced
    sums, each checked against the exact sum reduced (and, `wide`, the
    Wide model)."""
    nrows = len(f_rows)
    chunks = -(-nrows // 32)
    nt = 2 * d - 1 if comp else 2 * d

    def coef(n, row):
        if row >= nrows:
            return 0
        if not comp:
            return g_cols[n][row]
        e1 = n - row // k
        return g_cols[e1][row % k] if 0 <= e1 < d else 0

    stale = rng.integers(0, 1 << 63, size=(chunks * 32, 8)).tolist()
    rows = [f_rows[r] if r < nrows else stale[r] for r in range(chunks * 32)]
    vals = [[[rows[32 * kap + deep_row_of(m, t)][g] for m in range(8)]
             for g, t in zip(G, T)] for kap in range(chunks)]

    def bfrag(kap, n):
        return [sum(((coef(n, 32 * kap + deep_row_of(m, t)) >> (8 * g))
                     & 0xFF) << (8 * m) for m in range(8))
                for g, t in zip(G, T)]

    exact, red = quad_sums(run_tiles(vals, bfrag, nt), nt)
    for n in range(nt):
        for g in range(8):
            us = [f_rows[r][g] for r in range(nrows)]
            vs = [coef(n, r) for r in range(nrows)]
            assert exact[g][n] == sum(u * v for u, v in zip(us, vs))
            assert red[g][n] == exact[g][n] * R_INV % P
            assert not wide or red[g][n] == wide_sum(us, vs)
    return [[red[g][n] for g in range(8)] for n in range(nt)]


def _deep_inputs(rng, d, w, k, S, fill=None):
    draw = (lambda *s: rng.integers(0, P, size=s)) if fill is None else \
        (lambda *s: np.full(s, fill, dtype=np.int64))
    rnd = lambda *s: rng.integers(0, P, size=s)       # noqa: E731
    return dict(lde=draw(w, S), h=draw(d, k, S), xs=rnd(S), pts=rnd(d, 3),
                oz=rnd(d, w), ozg=rnd(d, w), oh=rnd(d, k), gz=draw(d, w),
                gzg=draw(d, w), gh=draw(d, k))


def deep_model(inp, d, w, k, S):
    """The deep kernel on 8-point groups: the sums on the tensor cores,
    cz from the OOD values, deep_point's polynomials in x, Montgomery's
    trick over runs of RUN[d] points (a zero norm replaced by 1, its point
    0) -> [d][S]."""
    rng = np.random.default_rng(0)
    L = lambda a: [[int(v) for v in r] for r in a]     # noqa: E731
    gz, gzg, gh = L(inp["gz"]), L(inp["gzg"]), L(inp["gh"])
    oz, ozg, oh, pts = L(inp["oz"]), L(inp["ozg"]), L(inp["oh"]), \
        L(inp["pts"])
    lde, h = L(inp["lde"]), [L(c) for c in inp["h"]]

    def csum(g, o, n):
        r = [0] * (2 * d - 1)
        for c in range(n):
            for i in range(d):
                for j in range(d):
                    r[i + j] += g[i][c] * o[j][c]
        return combine([v * R_INV % P for v in r])
    cz = [csum(gz, oz, w), csum(gzg, ozg, w), csum(gh, oh, k)]
    z = [[pts[e][q] for e in range(d)] for q in range(3)]
    us, norms = [], []
    for x0 in range(0, S, 8):
        xs = list(range(x0, min(x0 + 8, S)))
        pad = lambda r: [r[x] for x in xs] + [0] * (8 - len(xs))  # noqa
        tr = deep_group_sums(rng, [pad(lde[j]) for j in range(w)],
                             [g[e] for g in (gz, gzg) for e in range(d)],
                             False, d, k)
        co = deep_group_sums(rng, [pad(h[rc // k][rc % k])
                                   for rc in range(d * k)], gh, True, d, k)
        for i, x in enumerate(xs):
            n = [[msub(tr[q * d + e][i], cz[q][e]) for e in range(d)]
                 for q in range(2)]
            nh = combine([co[v][i] for v in range(2 * d - 1)])
            n.append([msub(nh[e], cz[2][e]) for e in range(d)])
            xv = int(inp["xs"][x])
            lin = [[msub(xv if e == 0 else 0, z[q][e]) for e in range(d)]
                   for q in range(3)]
            a, b = ext_mul(lin[1], lin[2]), ext_mul(lin[0], lin[2])
            c = ext_mul(lin[0], lin[1])
            den = ext_mul(c, lin[2])
            num = [add(add(p, q), r) for p, q, r in zip(
                ext_mul(n[0], a), ext_mul(n[1], b), ext_mul(n[2], c))]
            if d == 1:
                us.append(num)
                norms.append(den[0])
            else:
                adj, nrm = adj_norm(den)
                us.append(ext_mul(num, adj))
                norms.append(nrm)
    out = [[0] * S for _ in range(d)]
    R = RUN[d]
    for r0 in range(0, S, R):
        run = list(range(r0, min(r0 + R, S)))
        zero = [norms[j] == 0 for j in run]
        nrm = [ONE if zr else norms[j] for zr, j in zip(zero, run)]
        pre = [nrm[0]]
        for v in nrm[1:]:
            pre.append(mmul(pre[-1], v))
        inv = pow(pre[-1] * R_INV % P, P - 2, P) * (1 << 64) % P
        for i in range(len(run) - 1, -1, -1):
            ident = mmul(inv, pre[i - 1]) if i else inv
            if i:
                inv = mmul(inv, nrm[i])
            for e in range(d):
                out[e][run[i]] = 0 if zero[i] else mmul(us[run[i]][e], ident)
    return out


def _deep_plain(inp):
    t = {key: torch.from_numpy(np.asarray(v, dtype=np.int64))
         for key, v in inp.items()}
    return K.deep_plain(t["lde"], t["h"], t["xs"], t["pts"], t["oz"],
                        t["ozg"], t["oh"], t["gz"], t["gzg"], t["gh"])


# ---- ood -------------------------------------------------------------------
def ood_strip_sums(rng, rows, pw_cols, nb, nt, i0, m, wide=False):
    """A warp's row group over one strip: rows [8][m] coefficients (None:
    a pad row), pw_cols[n][i] the powers of n-tile n at index i; lane
    (g, t) K slot m of k-step kappa is index i0 + 32 kappa + 8t + m (0 past
    m). -> [n-tile][row] reduced sums, each checked as deep's are."""
    idx = lambda kap, t, mm: i0 + 32 * kap + 8 * t + mm   # noqa: E731
    vals = [[[rows[g][idx(kap, t, mm)] if rows[g] is not None and
              idx(kap, t, mm) < m else 0 for mm in range(8)]
             for g, t in zip(G, T)] for kap in range(OOD_STRIP // 32)]
    # the strip's power fragments as ood_kernel builds them: 8 indices of
    # a lane t, their bytes transposed by bytes8x8
    frag = {}
    for n in range(nt):
        for kap in range(OOD_STRIP // 32):
            words = [0] * 32
            for t in range(4):
                o = bytes8x8([pw_cols[nb + n][idx(kap, t, mm)]
                              for mm in range(8)])
                for g in range(8):
                    words[4 * g + t] = o[g]
            frag[kap, n] = words
    exact, red = quad_sums(run_tiles(vals, lambda kap, n: frag[kap, n], nt),
                           nt)
    for n in range(nt):
        for g in range(8):
            if rows[g] is None:
                continue
            top = min(m, i0 + OOD_STRIP)
            us = rows[g][i0:top]
            vs = pw_cols[nb + n][i0:top]
            assert exact[g][n] == sum(u * v for u, v in zip(us, vs))
            assert red[g][n] == exact[g][n] * R_INV % P
            assert not wide or red[g][n] == wide_sum(us, vs)
    return [[red[g][n] for g in range(8)] for n in range(nt)]


def ood_model(coef, h, pts, s, d):
    """ood: the power tables p_q^r and start powers p_q^(s + strip
    OOD_STRIP) (ext_pow), each index's power as their product, a strip's
    row groups on the tensor cores, the strips' sums added, the
    composition's coordinate products combined -> [d][2w + k]."""
    rng = np.random.default_rng(1)
    w, m = len(coef), len(coef[0])
    k = len(h[0])

    def epow(b, e):
        r, x = [ONE] + [0] * (d - 1), list(b)
        while e:
            if e & 1:
                r = ext_mul(r, x)
            e >>= 1
            x = ext_mul(x, x)
        return r
    strips = -(-m // OOD_STRIP)
    base = [[pts[e][q] for e in range(d)] for q in range(3)]
    tpow = [[[ONE] + [0] * (d - 1)] for _ in range(3)]
    for q in range(3):
        while len(tpow[q]) < OOD_STRIP:
            tpow[q].append(ext_mul(tpow[q][-1], base[q]))
    pw = [[0] * (strips * OOD_STRIP) for _ in range(3 * d)]
    for sg in range(strips):
        for q in range(3):
            st = epow(base[q], s + sg * OOD_STRIP)
            for r in range(OOD_STRIP):
                v = ext_mul(st, tpow[q][r])
                for e in range(d):
                    pw[q * d + e][sg * OOD_STRIP + r] = v[e]
    tr = [[0] * w for _ in range(2 * d)]
    cp = [[[0] * d for _ in range(k)] for _ in range(d)]   # [e1][c][e2]
    for sg in range(strips):
        i0 = sg * OOD_STRIP
        for rg in range(-(-w // 8)):
            rows = [coef[8 * rg + g] if 8 * rg + g < w else None
                    for g in range(8)]
            got = ood_strip_sums(rng, rows, pw, 0, 2 * d, i0, m)
            for n in range(2 * d):
                for g in range(8):
                    if rows[g] is not None:
                        tr[n][8 * rg + g] = add(tr[n][8 * rg + g], got[n][g])
        for rg in range(-(-(d * k) // 8)):
            rcs = [8 * rg + g for g in range(8)]
            rows = [h[rc // k][rc % k] if rc < d * k else None for rc in rcs]
            got = ood_strip_sums(rng, rows, pw, 2 * d, d, i0, m)
            for e2 in range(d):
                for g, rc in enumerate(rcs):
                    if rc < d * k:
                        e1, c = rc // k, rc % k
                        cp[e1][c][e2] = add(cp[e1][c][e2], got[e2][g])
    out = [[0] * (2 * w + k) for _ in range(d)]
    for n in range(2 * d):
        q, e = n // d, n % d
        for j in range(w):
            out[e][q * w + j] = tr[n][j]
    for c in range(k):
        r = [0] * (2 * d - 1)
        for e1 in range(d):
            for e2 in range(d):
                r[e1 + e2] = add(r[e1 + e2], cp[e1][c][e2])
        for e, v in enumerate(combine(r)):
            out[e][2 * w + c] = v
    return out


# ---- tests -----------------------------------------------------------------
def test_constants_follow_source():
    """The wrapper's limits are the kernel's; every s32 sum's term count
    is within MAX_U8_TERMS, the largest for which 255^2 terms fit; the
    2^(16t) factors; DEEP_ROW keeps a half-warp's 8-byte reads of a chunk
    in 32 distinct banks."""
    assert (K.OOD_STRIP, K.DEEP_MAX_W, K.DEEP_MAX_K) == \
        (OOD_STRIP, DEEP_MAX_W, DEEP_MAX_K)
    assert 255 ** 2 * MAX_U8_TERMS < 1 << 31 <= 255 ** 2 * (MAX_U8_TERMS + 1)
    assert max(OOD_STRIP, DEEP_MAX_W, 3 * DEEP_MAX_K) <= MAX_U8_TERMS
    assert OOD_STRIP % 32 == 0 and min(RUN.values()) >= 1
    assert len(PERMS) == 8 and C126 == (1 << 126) % P
    assert (P - 1) >> 56 == 0x41 and DEEP_ROW % 16 == 0
    for m in range(8):
        for warp in range(4):
            for half in (range(16), range(16, 32)):
                banks = set()
                for lane in half:
                    g, t = lane >> 2, lane & 3
                    word = (deep_row_of(m, t) * DEEP_ROW
                            + 8 * (8 * warp + g)) // 4
                    banks |= {word % 32, (word + 1) % 32}
                assert len(banks) == 32
    assert "((m + 2 * t) & 7)" in SRC and "((m + 2 * (ln & 3)) & 7)" in SRC


def test_byte_transposes():
    """bytes4x4, a_frags and bytes8x8 with the source's prmt selectors:
    each register holds the bytes the fragment layout asks for."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, P, size=(40, 8)).tolist() + \
        [[P - 1] * 8, [BYTES_MAX] * 8, list(range(8))]
    for v in vals:
        A = a_frags(v)
        for u in range(4):
            for reg in range(4):
                a, base = 2 * u + (reg & 1), 4 * (reg >> 1)
                want = sum(((v[base + i] >> (8 * a)) & 0xFF) << (8 * i)
                           for i in range(4))
                assert A[u][reg] == want
        o = bytes8x8(v)
        for g in range(8):
            assert o[g] == sum(((v[m] >> (8 * g)) & 0xFF) << (8 * m)
                               for m in range(8))


def test_sum_bounds():
    """share_x and quad_sums with every accumulator at the largest value
    MAX_U8_TERMS allows, for 1 .. 8 sums: no 64-bit word wraps, V and
    its fold within their bounds (checked inside), each reduced sum
    V 2^-64 mod p."""
    top = 255 ** 2 * MAX_U8_TERMS
    for n_sums in range(1, 9):
        acc = [[[[top] * 4] * 4] * n_sums] * 32
        exact, red = quad_sums(acc, n_sums)
        xl, xh = share_x([[top] * 4] * 4)
        v = sum((xl | xh << 64) << (16 * t) for t in range(4))
        assert all(e == v and r == v * R_INV % P
                   for row_e, row_r in zip(exact, red)
                   for e, r in zip(row_e, row_r))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_deep_model_matches_plain(d):
    """The deep kernel's model on 13 points (a ragged group) of w = 37
    columns and k = 3: every sum exact and equal to the Wide model, the
    result equal to deep_plain, a zero denominator's point 0."""
    rng = np.random.default_rng(10 + d)
    w, k, S = 37, 3, 13
    inp = _deep_inputs(rng, d, w, k, S)
    inp["xs"][4] = inp["pts"][0, 0]
    if d > 1:
        inp["pts"][1:, 0] = 0           # z in the base field: x = z at 4
    got = deep_model(inp, d, w, k, S)
    want = _deep_plain(inp)
    assert torch.equal(torch.tensor(got, dtype=torch.int64), want)
    assert all(got[e][4] == 0 for e in range(d))


@pytest.mark.parametrize("fill", [P - 1, BYTES_MAX],
                         ids=["p-1", "bytes-max"])
def test_deep_sums_widest(fill):
    """deep's trace sums at the widest trace it takes (DEEP_MAX_W columns)
    and its composition sums at DEEP_MAX_K columns, d = 3, every value
    `fill` (p - 1, and the canonical value with the most 0xFF bytes): the
    accumulators run longest there; exact and equal to the Wide model."""
    rng = np.random.default_rng(5)
    d = 3
    rows = [[fill] * 8 for _ in range(DEEP_MAX_W)]
    deep_group_sums(rng, rows, [[fill] * DEEP_MAX_W] * (2 * d), False, d,
                    DEEP_MAX_K, wide=True)
    rows = [[fill] * 8 for _ in range(d * DEEP_MAX_K)]
    deep_group_sums(rng, rows, [[fill] * DEEP_MAX_K] * d, True, d,
                    DEEP_MAX_K, wide=True)


@pytest.mark.parametrize("d", [1, 3])
def test_ood_model_matches_plain(d):
    """ood's model over two strips (the second ragged) with a start
    exponent: 9 trace columns (one pad row) and k = 2 at d = 1, 3, equal
    to ood_plain; every sum exact."""
    rng = np.random.default_rng(20 + d)
    w, k, m, s = 9, 2, OOD_STRIP + 37, 1000003
    coef = rng.integers(0, P, size=(w, m))
    h = rng.integers(0, P, size=(d, k, m))
    pts = rng.integers(0, P, size=(d, 3))
    got = ood_model(coef.tolist(), h.tolist(), pts.tolist(), s, d)
    oz, ozg, oh = K.ood_plain(*(torch.from_numpy(a) for a in (coef, h, pts)),
                              s)
    want = torch.cat([oz, ozg, oh], dim=1)
    assert torch.equal(torch.tensor(got, dtype=torch.int64), want)


@pytest.mark.parametrize("fill", [P - 1, BYTES_MAX],
                         ids=["p-1", "bytes-max"])
def test_ood_strip_worst(fill):
    """A whole strip (OOD_STRIP indices, every s32 sum at its most terms)
    of coefficients and powers all `fill`: exact, equal to the Wide
    model."""
    rng = np.random.default_rng(7)
    rows = [[fill] * OOD_STRIP for _ in range(8)]
    ood_strip_sums(rng, rows, [[fill] * OOD_STRIP] * 2, 0, 2, 0, OOD_STRIP,
                   wide=True)
