"""Cheetah-f63 curve host utilities for the witness: the curve instance,
key derivation and Schnorr signing (from certificate_stark_tpu/utils/curve.py,
in Python ints only; the affine point arithmetic and signature
verification of that module have no caller in the port yet).

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
    global CURVE_NAME, B_LIMBS, SCALAR_Q, GEN12, B3_LIMBS
    inst = _load(name)
    CURVE_NAME = inst["name"]
    B_LIMBS = inst["b_limbs"]
    SCALAR_Q = inst["scalar_q"]
    GEN12 = inst["gen12"]
    B3_LIMBS = [(3 * v) % P for v in B_LIMBS]  # in-circuit b3 constant


set_curve(os.environ.get("CSTARK_CURVE", "fp2"))


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


def sign(message28, skey: int, rng) -> tuple:
    r = rng.randrange(1, SCALAR_Q)
    r_x = mul_gen(r)[:6]
    s = (r - skey * (h_scalar(hash_message(r_x, message28)) % SCALAR_Q)) \
        % SCALAR_Q
    return (r_x, s)
