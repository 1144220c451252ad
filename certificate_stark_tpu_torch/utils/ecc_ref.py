"""Python-int reference of the in-circuit point formulas (a copy of
certificate_stark_tpu/utils/ecc_ref.py, after the reference's
src/utils/ecc.rs:176-405). These must be FORMULA-identical (same projective
coordinates), since the trace stores the exact intermediate X:Y:Z values that
the constraints recompute.

State layout: point = list of 18 ints [X(6) || Y(6) || Z(6)].
"""
from __future__ import annotations

from . import field_ref as FR
from . import curve as _CV  # late-bound: B3_LIMBS changes with set_curve()

P = FR.P


def _f6(lims):
    return FR.f6_from_limbs(lims)


def _limbs(a):
    return FR.f6_to_limbs(a)


def compute_double(state18, b3_limbs=None):
    """RCB-style doubling for y^2 = x^3 + x + b (ecc.rs:186-243)."""
    b3 = _f6(b3_limbs or _CV.B3_LIMBS)
    x = _f6(state18[0:6])
    y = _f6(state18[6:12])
    z = _f6(state18[12:18])
    m, a, s, d = FR.f6_mul, FR.f6_add, FR.f6_sub, lambda v: FR.f6_add(v, v)

    t0 = m(x, x)
    t1 = m(y, y)
    t2 = m(z, z)
    t3 = d(m(x, y))
    z3 = d(m(x, z))
    y3 = m(b3, t2)
    y3 = a(z3, y3)
    x3 = s(t1, y3)
    y3 = a(t1, y3)
    y3 = m(x3, y3)
    x3 = m(t3, x3)
    z3 = m(b3, z3)
    t3 = s(t0, t2)
    t3 = a(t3, z3)
    z3 = d(t0)
    t0 = a(z3, t0)
    t0 = a(t0, t2)
    t0 = m(t0, t3)
    y3 = a(y3, t0)
    t2 = d(m(y, z))
    t0 = m(t2, t3)
    x3 = s(x3, t0)
    z3 = d(m(t2, t1))
    z3 = d(z3)
    return _limbs(x3) + _limbs(y3) + _limbs(z3)


def compute_add(state18, point18, b3_limbs=None):
    """Full projective addition (ecc.rs:245-325)."""
    b3 = _f6(b3_limbs or _CV.B3_LIMBS)
    x1, y1, z1 = _f6(state18[0:6]), _f6(state18[6:12]), _f6(state18[12:18])
    x2, y2, z2 = _f6(point18[0:6]), _f6(point18[6:12]), _f6(point18[12:18])
    m, a, s, d = FR.f6_mul, FR.f6_add, FR.f6_sub, lambda v: FR.f6_add(v, v)

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t2 = m(z1, z2)
    t3 = m(a(x1, y1), a(x2, y2))
    t3 = s(t3, a(t0, t1))
    t4 = m(a(x1, z1), a(x2, z2))
    t4 = s(t4, a(t0, t2))
    t5 = m(a(y1, z1), a(y2, z2))
    t5 = s(t5, a(t1, t2))
    x3 = m(b3, t2)
    z3 = a(x3, t4)
    x3 = s(t1, z3)
    z3 = a(t1, z3)
    y3 = m(x3, z3)
    t1 = a(d(t0), t0)
    t4 = m(b3, t4)
    t1 = a(t1, t2)
    t2 = s(t0, t2)
    t4 = a(t4, t2)
    t0 = m(t1, t4)
    y3 = a(y3, t0)
    t0 = m(t5, t4)
    x3 = m(t3, x3)
    x3 = s(x3, t0)
    t0 = m(t3, t1)
    z3 = m(t5, z3)
    z3 = a(z3, t0)
    return _limbs(x3) + _limbs(y3) + _limbs(z3)


def compute_add_mixed(state18, point12, b3_limbs=None):
    """Mixed addition, rhs affine with Z2 == 1 (ecc.rs:330-405)."""
    b3 = _f6(b3_limbs or _CV.B3_LIMBS)
    x1, y1, z1 = _f6(state18[0:6]), _f6(state18[6:12]), _f6(state18[12:18])
    x2, y2 = _f6(point12[0:6]), _f6(point12[6:12])
    m, a, s, d = FR.f6_mul, FR.f6_add, FR.f6_sub, lambda v: FR.f6_add(v, v)

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t3 = m(a(x2, y2), a(x1, y1))
    t3 = s(t3, a(t0, t1))
    t4 = a(m(x2, z1), x1)
    t5 = a(m(y2, z1), y1)
    x3 = m(z1, b3)
    z3 = a(x3, t4)
    x3 = s(t1, z3)
    z3 = a(t1, z3)
    y3 = m(x3, z3)
    t1 = a(d(t0), t0)
    t4 = m(t4, b3)
    t1 = a(t1, z1)
    t2 = s(t0, z1)
    t4 = a(t4, t2)
    t0 = m(t1, t4)
    y3 = a(y3, t0)
    t0 = m(t5, t4)
    x3 = m(t3, x3)
    x3 = s(x3, t0)
    t0 = m(t3, t1)
    z3 = m(t5, z3)
    z3 = a(z3, t0)
    return _limbs(x3) + _limbs(y3) + _limbs(z3)


def to_affine_x(state18):
    x = _f6(state18[0:6])
    z = _f6(state18[12:18])
    return _limbs(FR.f6_mul(x, FR.f6_inv(z)))
