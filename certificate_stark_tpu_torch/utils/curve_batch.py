"""Batched fixed-base Cheetah-f63 curve operations for witness generation at
scale: key derivation and Schnorr signing for whole transaction batches (a
copy of certificate_stark_tpu/utils/curve_batch.py, in Python ints only).

All witness-side scalar multiplications are FIXED-BASE (pkey = skey*G and
R = r*G; reference schnorr::sign, src/lib.rs:440-448 / schnorr/mod.rs:197-217),
so they run through a 4-bit comb table of the generator: 64 windows x 15 odd
multiples, precomputed once per process with the projective Python-int
formulas (utils/ecc_ref.py — no per-add field inversion), and ONE Montgomery
batch inversion normalizes every output point at the end. ~10 ms per scalar
vs ~640 ms for the naive affine double-and-add.
"""
from __future__ import annotations

from . import curve as CV
from . import ecc_ref as ER
from . import field_ref as FR

_COMB_W = 4
_COMB_WINDOWS = 64           # covers 256-bit scalars
_COMB = {}                   # curve name -> [win][j-1] affine j*2^(4win)*G
IDENTITY18 = (0,) * 6 + (1,) + (0,) * 11     # projective identity (0:1:0)


def _batch_affine(projs):
    """Projective 18-limb points -> affine 12-limb lists with one shared
    field inversion (Montgomery batch-inverse over the Z coordinates).
    Callers guarantee no point is the identity (scalars are in [1, Q))."""
    zs = [FR.f6_from_limbs(p[12:18]) for p in projs]
    pre = [zs[0]]
    for z in zs[1:]:
        pre.append(FR.f6_mul(pre[-1], z))
    inv_run = FR.f6_inv(pre[-1])
    invs = [None] * len(zs)
    for i in range(len(zs) - 1, 0, -1):
        invs[i] = FR.f6_mul(inv_run, pre[i - 1])
        inv_run = FR.f6_mul(inv_run, zs[i])
    invs[0] = inv_run
    out = []
    for p, zi in zip(projs, invs):
        x = FR.f6_mul(FR.f6_from_limbs(p[0:6]), zi)
        y = FR.f6_mul(FR.f6_from_limbs(p[6:12]), zi)
        out.append(FR.f6_to_limbs(x) + FR.f6_to_limbs(y))
    return out


def _comb_table():
    tbl = _COMB.get(CV.CURVE_NAME)
    if tbl is None:
        g12 = list(CV.GEN12)
        one6 = FR.f6_to_limbs(FR.f6_scalar(1))
        # pass 1: window bases 2^(4w)*G, projectively, one batch normalize
        bases = []
        cur = g12 + one6
        for w in range(_COMB_WINDOWS):
            bases.append(cur)
            if w < _COMB_WINDOWS - 1:
                for _ in range(_COMB_W):
                    cur = ER.compute_double(cur)
        bases12 = _batch_affine(bases)
        # pass 2: rows j*base for j=1..15, one batch normalize over all
        projs = []
        for b12 in bases12:
            cur = b12 + one6
            projs.append(cur)
            for _ in range(2, 16):
                cur = ER.compute_add_mixed(cur, b12)
                projs.append(cur)
        flat = _batch_affine(projs)
        tbl = [flat[w * 15:(w + 1) * 15] for w in range(_COMB_WINDOWS)]
        _COMB[CV.CURVE_NAME] = tbl
    return tbl


def multiples(pt12, m):
    """[j * pt for j = 1..m] as affine 12-limb lists, for an affine point of
    order above m."""
    one6 = FR.f6_to_limbs(FR.f6_scalar(1))
    projs = [list(pt12) + one6]
    for _ in range(m - 1):
        projs.append(ER.compute_add_mixed(projs[-1], pt12))
    return _batch_affine(projs)


def mul_gen_proj(k):
    """k * G as a projective 18-limb point through the comb table (k is
    taken mod the group order; 0 gives the identity)."""
    tbl = _comb_table()
    k = int(k) % CV.SCALAR_Q
    acc = list(IDENTITY18)
    for w in range(_COMB_WINDOWS):
        j = (k >> (_COMB_W * w)) & 15
        if j:
            acc = ER.compute_add_mixed(acc, tbl[w][j - 1])
        if (k >> (_COMB_W * (w + 1))) == 0:
            break
    return acc


def batch_mul_gen(scalars):
    """[k_0..k_{T-1}] -> affine points [T][12 limbs] of k_i * G, k_i in
    [1, Q)."""
    if not scalars:
        return []
    return _batch_affine([mul_gen_proj(k) for k in scalars])


def batch_pkeys(skeys):
    return batch_mul_gen(skeys)


def batch_sign(messages, skeys, rng):
    """Schnorr-sign a batch: returns [(r_x 6 limbs, s int)] per message."""
    T = len(messages)
    rs = [rng.randrange(1, CV.SCALAR_Q) for _ in range(T)]
    r_points = batch_mul_gen(rs)
    sigs = []
    for i in range(T):
        r_x = r_points[i][:6]
        h = CV.hash_message(r_x, messages[i])
        s = (rs[i] - skeys[i] * (CV.h_scalar(h) % CV.SCALAR_Q)) % CV.SCALAR_Q
        sigs.append((list(r_x), s))
    return sigs
