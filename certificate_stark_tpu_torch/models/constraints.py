"""Constraint evaluators shared by the AIRs, generic over the field facade
fx (engine/fieldops.py). Counterpart of
certificate_stark_tpu/models/constraints.py."""
from __future__ import annotations


def rescue_enforce_round(fx, cur, nxt, ark0, ark1):
    """Rescue round constraint on stacked states [14, B] (reference
    src/utils/rescue.rs:269-300): the forward half-round from `cur` must
    equal the inverted second half-round of `nxt`. ark0/ark1 are the
    half-round constant columns [14, B]. Returns the unflagged constraint
    values [14, B]."""
    step1 = fx.add(fx.rescue_mds(fx.sbox3(cur)), ark0)
    step2 = fx.sbox3(fx.rescue_inv_mds(fx.sub(nxt, ark1)))
    return fx.sub(step2, step1)


def double_and_add(fx, acc_cur, acc_nxt, bit_nxt):
    """acc' == 2*acc + bit' (reference src/utils/field.rs:31-50). Returns
    (acc_constraint, binary_constraint)."""
    c_acc = fx.sub(acc_nxt, fx.add(fx.double(acc_cur), bit_nxt))
    c_bit = fx.sub(fx.mul(bit_nxt, bit_nxt), bit_nxt)
    return c_acc, c_bit
