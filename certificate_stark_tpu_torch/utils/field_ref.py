"""Python-int f63 and its fp2/fp6 tower for host-side work (the witness,
signature checks): a copy of certificate_stark_tpu/utils/field_ref.py.

fp2 = fp[u]/(u^2-2u-2), fp6 = fp2[v]/(v^3+v+1), after the reference's
src/utils/ecc.rs:407-648. `f6_inv` takes the norm route of ops/ecc.py
`f6_inv` (one base-field inverse), not the JAX module's a^(p^6-2): the
inverse is the same field value either way.
"""
from __future__ import annotations

from ..params.data import P


def fadd(a, b):
    return (a + b) % P


def fsub(a, b):
    return (a - b) % P


def fmul(a, b):
    return (a * b) % P


def finv(a):
    return pow(a, P - 2, P)


# --- fp2 = fp[u]/(u^2 - 2u - 2) -------------------------------------------------
def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] + 2 * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0] + 2 * a[1] * b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_inv(a):
    # norm w.r.t. conjugate u -> 2-u : a0^2 + 2 a0 a1 - 2 a1^2
    t = finv((a[0] * a[0] + 2 * a[0] * a[1] - 2 * a[1] * a[1]) % P)
    return ((a[0] + 2 * a[1]) * t % P, (-a[1]) * t % P)


# --- fp6 = fp2[v]/(v^3 + v + 1) -------------------------------------------------
F6_ZERO = ((0, 0), (0, 0), (0, 0))
F6_ONE = ((1, 0), (0, 0), (0, 0))


def f6_from_limbs(l):
    return ((l[0] % P, l[1] % P), (l[2] % P, l[3] % P), (l[4] % P, l[5] % P))


def f6_to_limbs(a):
    return [a[0][0], a[0][1], a[1][0], a[1][1], a[2][0], a[2][1]]


def f6_scalar(c):
    return ((c % P, 0), (0, 0), (0, 0))


def f6_add(A, B):
    (a0, a1), (a2, a3), (a4, a5) = A
    (b0, b1), (b2, b3), (b4, b5) = B
    return (((a0 + b0) % P, (a1 + b1) % P), ((a2 + b2) % P, (a3 + b3) % P),
            ((a4 + b4) % P, (a5 + b5) % P))


def f6_sub(A, B):
    (a0, a1), (a2, a3), (a4, a5) = A
    (b0, b1), (b2, b3), (b4, b5) = B
    return (((a0 - b0) % P, (a1 - b1) % P), ((a2 - b2) % P, (a3 - b3) % P),
            ((a4 - b4) % P, (a5 - b5) % P))


def f6_neg(A):
    return tuple(f2_neg(x) for x in A)


def f6_mul(A, B):
    """The nine fp2 products of the schoolbook fp6 multiply, unreduced
    (x * y = (x0 y0 + 2 x1 y1) + (x0 y1 + x1 y0 + 2 x1 y1) u, as
    u^2 = 2u + 2), combined with v^3 = -v - 1 and v^4 = -v - v^2 and
    reduced once per coordinate: the same value as the fp2-by-fp2 form."""
    (a0, a1), (a2, a3), (a4, a5) = A
    (b0, b1), (b2, b3), (b4, b5) = B
    t = 2 * a1 * b1
    aa0, aa1 = a0 * b0 + t, a0 * b1 + a1 * b0 + t
    t = 2 * a3 * b3
    bb0, bb1 = a2 * b2 + t, a2 * b3 + a3 * b2 + t
    t = 2 * a5 * b5
    cc0, cc1 = a4 * b4 + t, a4 * b5 + a5 * b4 + t
    t = 2 * (a3 * b5 + a5 * b3)                       # v^3: a1 b2 + a2 b1
    c30 = a2 * b4 + a4 * b2 + t
    c31 = a2 * b5 + a3 * b4 + a4 * b3 + a5 * b2 + t
    t = 2 * (a1 * b3 + a3 * b1)                       # v: a0 b1 + a1 b0
    m0 = a0 * b2 + a2 * b0 + t
    m1 = a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0 + t
    t = 2 * (a1 * b5 + a5 * b1)                       # v^2: a0 b2 + a2 b0
    n0 = a0 * b4 + a4 * b0 + t
    n1 = a0 * b5 + a1 * b4 + a4 * b1 + a5 * b0 + t
    return (((aa0 - c30) % P, (aa1 - c31) % P),
            ((m0 - c30 - cc0) % P, (m1 - c31 - cc1) % P),
            ((n0 + bb0 - cc0) % P, (n1 + bb1 - cc1) % P))


def f6_pow(A, e):
    r = F6_ONE
    while e:
        if e & 1:
            r = f6_mul(r, A)
        A = f6_mul(A, A)
        e >>= 1
    return r


def f6_inv(A):
    """A^-1 by the reference's invert_fp6 sequence (ecc.rs:551-591): the
    fp2 norm over fp6, one fp2 inverse, three fp2 products. Zero maps to
    zero, as A^(p^6-2) does."""
    c0, c1, c2 = A
    m, ad, sb = f2_mul, f2_add, f2_sub
    c0_sq, c1_sq, c2_sq = m(c0, c0), m(c1, c1), m(c2, c2)
    t = sb(m(c0, ad(c0_sq, c1_sq)), m(c1, c1_sq))
    t = ad(t, m(ad(c0, sb(c2, c1)), c2_sq))
    tmp = m(sb(ad(c0_sq, c0_sq), m(ad(ad(c0, c0), c0), c1)), c2)
    t = f2_inv(sb(t, tmp))
    r0 = m(sb(ad(ad(c0_sq, c1_sq), c2_sq), m(sb(ad(c0, c0), c1), c2)), t)
    r1 = f2_neg(m(ad(m(c0, c1), c2_sq), t))
    r2 = m(ad(sb(c1_sq, m(c0, c2)), c2_sq), t)
    return (r0, r1, r2)


def f6_is_zero(A):
    return all(x == (0, 0) for x in A)

