"""Boundary (assertion) constraint tables for the prover.

Counterpart of certificate_stark_tpu/engine/boundary.py
(`group_assertions`, `quotient_degree`, `build_boundary_tables`):

  single   (col, step, v):        numer = T_col - v,    Z = x - g^step
  periodic (col, first, T, v):    numer = T_col - v,    Z = x^m - g^(first*m)
  sequence (col, first, T, vals): numer = T_col - B(x), Z = x^m - g^(first*m)

with m = n/T and B(x) = q(x * g^-first), q interpolating vals over the
size-m subgroup. Assertions sharing a divisor form one group with one
inverse-divisor table and one degree adjustment. Tables live on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import field as F, ntt as NTT
from ..utils import poly_host as PH
from .air import Assertion, SequenceAssertion


@dataclass
class BoundaryGroup:
    key: tuple
    columns: list                # trace columns of the group's assertions
    b_evals: torch.Tensor        # [g, 1] constant values, [g, count] sequences
    inv_z: torch.Tensor          # [count] inverse divisor on the points
    adj: int
    assertions: list


def group_assertions(assertions, n):
    groups = {}
    for a in assertions:
        key = ("s", a.step) if isinstance(a, Assertion) \
            else ("p", a.first_step, a.period)
        groups.setdefault(key, []).append(a)
    return groups


def quotient_degree(key, n):
    if key[0] == "s":
        return n - 2
    return n - 1 - n // key[2]


def _divisor_inv(key, n, bn, offset, g_trace, xs, j0):
    """The inverse divisor at the points xs [count] = x_j0 .. of the LDE
    domain."""
    if key[0] == "s":
        c = F.const(pow(g_trace, key[1], F.P), xs.device)
        return F.batch_inv(F.sub(xs, c))
    # x^m - c has period bn/m on the coset: invert one period (or the
    # points' part of it) and tile
    m = n // key[2]
    c = pow(g_trace, key[1] * m, F.P)
    period = bn // m if m <= bn else 1
    count = xs.shape[-1]
    span = min(period, count)         # j0 is a multiple of span
    w_m = pow(PH.root_of_unity(bn), m, F.P)
    pts = F.mul(F.powers(w_m, span, xs.device),
                F.const(pow(offset, m, F.P) * pow(w_m, j0 % period, F.P),
                        xs.device))
    return F.batch_inv(F.sub(pts, F.const(c, xs.device))) \
        .repeat(count // span)


def _sequence_evals(n, bn, offset, g_trace, first, period, values, device):
    """B(x) on the LDE domain: q's coefficients over the coset
    (offset * g^-first) * <w_bn>."""
    m = n // period
    q = PH.intt([int(v) % F.P for v in values])
    assert len(q) == m
    shift = offset * pow(pow(g_trace, first, F.P), F.P - 2, F.P) % F.P
    return NTT.lde_from_coeffs(F.from_ints(q, device), bn // m, shift)


def build_boundary_tables(assertions, n, bn, offset, g_trace, comp_deg, xs,
                          j0=0):
    """Per-group tables; xs [count] are the LDE-domain points j0 ..
    j0 + count - 1 (Montgomery), all bn of them unless j0 and count name a
    block of the domain."""
    count = xs.shape[-1]
    out = []
    for key, group in group_assertions(assertions, n).items():
        # a sequence's B(x) on a block is a slice of its LDE over the whole
        # domain: a block is no coset of a subgroup, so no transform of the
        # block's size gives it, and B at the block's points one by one
        # costs m = n/period products a point against log2(m) the transform
        if any(isinstance(a, SequenceAssertion) for a in group):
            b_evals = torch.stack([
                _sequence_evals(n, bn, offset, g_trace, a.first_step,
                                a.period, a.values, xs.device)[j0:j0 + count]
                if isinstance(a, SequenceAssertion) else
                F.const(a.value, xs.device).expand(count)
                for a in group])
        else:
            b_evals = F.from_ints([[a.value] for a in group], xs.device)
        out.append(BoundaryGroup(
            key=key, columns=[a.column for a in group], b_evals=b_evals,
            inv_z=_divisor_inv(key, n, bn, offset, g_trace, xs, j0),
            adj=comp_deg - quotient_degree(key, n), assertions=group))
    return out
