"""Cheetah-f63 curve host utilities: the curve instance, affine point
arithmetic, key derivation, Schnorr signing and verification (from
certificate_stark_tpu/utils/curve.py, in Python ints only).

Curve form: E: y^2 = x^3 + x + b over fp6 = fp2[v]/(v^3+v+1),
fp2 = fp[u]/(u^2-2u-2). Two order-verified instances, selected by
CSTARK_CURVE (or set_curve()), with the same default as the JAX package:

  * "fp2"      (default) b = 5 + 29u in F_p2 (params/curve_fp2.py): 245-bit
               prime scalar field.
  * "subfield" b = 57 in F_p (params/curve_subfield.py): 125-bit prime
               scalar field, for fast tests.

The in-circuit formulas and trace layout are identical across instances;
only the curve constant b (hence b3 = 3b) and the generator differ.
"""
from __future__ import annotations

import os

from . import field_ref as FR
from . import rescue_ref as RR
from ..params.data import P


def _load(name: str) -> dict:
    if name == "subfield":
        from ..params import curve_subfield as M
        from ..params import curve_subfield_gen as G
        b_limbs = [M.B0, 0, 0, 0, 0, 0]
    elif name == "fp2":
        from ..params import curve_fp2 as M
        G = M
        b_limbs = list(M.B_LIMBS)
    else:
        raise ValueError(f"unknown curve instance {name!r} "
                         "(choices: fp2, subfield)")
    return dict(name=name, b_limbs=b_limbs, scalar_q=M.SCALAR_Q,
                gen12=list(G.GX) + list(G.GY))


def set_curve(name: str) -> None:
    """Select the curve instance; rebinds the module globals (the comb
    tables of utils/curve_batch.py are kept per instance)."""
    global CURVE_NAME, B_LIMBS, SCALAR_Q, GEN12, B6, B3_LIMBS
    inst = _load(name)
    CURVE_NAME = inst["name"]
    B_LIMBS = inst["b_limbs"]
    SCALAR_Q = inst["scalar_q"]
    GEN12 = inst["gen12"]
    B6 = FR.f6_from_limbs(B_LIMBS)
    B3_LIMBS = [(3 * v) % P for v in B_LIMBS]  # in-circuit b3 constant


A6 = FR.f6_scalar(1)
set_curve(os.environ.get("CSTARK_CURVE", "fp2"))


# ---- affine point ops (None = infinity) -----------------------------------
def on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = FR.f6_mul(y, y)
    rhs = FR.f6_add(FR.f6_add(FR.f6_mul(x, FR.f6_mul(x, x)), x), B6)
    return lhs == rhs


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if FR.f6_is_zero(FR.f6_add(y1, y2)):
            return None
        num = FR.f6_add(FR.f6_mul(FR.f6_scalar(3), FR.f6_mul(x1, x1)), A6)
        den = FR.f6_inv(FR.f6_mul(FR.f6_scalar(2), y1))
    else:
        num = FR.f6_sub(y2, y1)
        den = FR.f6_inv(FR.f6_sub(x2, x1))
    lam = FR.f6_mul(num, den)
    x3 = FR.f6_sub(FR.f6_sub(FR.f6_mul(lam, lam), x1), x2)
    y3 = FR.f6_sub(FR.f6_mul(lam, FR.f6_sub(x1, x3)), y1)
    return (x3, y3)


def mul(k: int, pt):
    r = None
    k = int(k)
    while k:
        if k & 1:
            r = add(r, pt)
        pt = add(pt, pt)
        k >>= 1
    return r


def generator():
    return (FR.f6_from_limbs(GEN12[:6]), FR.f6_from_limbs(GEN12[6:]))


def mul_gen(k: int) -> list:
    """Fixed-base k*G -> affine 12 limbs, via the comb table
    (utils/curve_batch.py)."""
    from . import curve_batch as CB
    return CB.batch_mul_gen([k])[0]


def pkey_coords(skey: int) -> list:
    """Affine (x||y) 12 limbs of skey*G."""
    return mul_gen(skey)


# ---- Schnorr (reference src/schnorr/mod.rs:197-288) ------------------------
def hash_message(r_x6, message28) -> list:
    """h = iterated Rescue hash of (R_x || message), 7 elements."""
    h = RR.digest(list(r_x6))
    for i in range(4):
        h = RR.merge(h, list(message28[7 * i:7 * i + 7]))
    return h


def h_scalar(h7) -> int:
    """The first 4 digest limbs' 8-byte LE serialization as an integer."""
    return int.from_bytes(
        b"".join(int(x).to_bytes(8, "little") for x in h7[:4]), "little")


def h_to_scalar_bits(h7) -> list:
    """256 bits (LSB first) of `h_scalar` (schnorr/mod.rs:205-213 + trace
    bit usage)."""
    v = h_scalar(h7)
    return [(v >> i) & 1 for i in range(256)]


def sign(message28, skey: int, rng) -> tuple:
    r = rng.randrange(1, SCALAR_Q)
    r_x = mul_gen(r)[:6]
    s = (r - skey * (h_scalar(hash_message(r_x, message28)) % SCALAR_Q)) \
        % SCALAR_Q
    return (r_x, s)


def _mul_proj(k: int, pt12) -> list:
    """k * pt for an affine point (12 limbs) as a projective 18-limb point,
    by a 4-bit fixed window over the in-circuit complete formulas
    (utils/ecc_ref.py): no field inversion."""
    from . import curve_batch as CB
    from . import ecc_ref as ER
    table = [None] + CB.multiples(pt12, 15)      # j * pt, affine, j = 1..15
    acc = list(CB.IDENTITY18)
    for w in reversed(range((int(k).bit_length() + 3) // 4)):
        for _ in range(4):
            acc = ER.compute_double(acc)
        j = (int(k) >> (4 * w)) & 15
        if j:
            acc = ER.compute_add_mixed(acc, table[j])
    return acc


def verify_signature(message28, signature) -> bool:
    """True iff s*G + h*P has the affine x-coordinate r_x, with P the
    public key in message28[0:12] and h the message hash: the JAX package's
    boolean, computed projectively (s*G through the comb table, h*P by a
    fixed window) with one fp6 inversion at the end, where the JAX module
    adds affinely with an inversion per addition."""
    from . import curve_batch as CB
    from . import ecc_ref as ER
    r_x, s = signature
    pk12 = [int(v) % P for v in message28[0:12]]
    assert on_curve((FR.f6_from_limbs(pk12[:6]), FR.f6_from_limbs(pk12[6:])))
    h = h_scalar(hash_message(list(r_x), message28)) % SCALAR_Q
    r18 = ER.compute_add(CB.mul_gen_proj(int(s)), _mul_proj(h, pk12))
    z = FR.f6_from_limbs(r18[12:18])
    if FR.f6_is_zero(z):                        # s*G + h*P is infinity
        return False
    x = FR.f6_mul(FR.f6_from_limbs(r18[0:6]), FR.f6_inv(z))
    return FR.f6_to_limbs(x) == list(r_x)
