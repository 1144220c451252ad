"""Python-int fp2/fp6 tower over f63 for host-side witness work: the part
of certificate_stark_tpu/utils/field_ref.py that the witness uses.

fp2 = fp[u]/(u^2-2u-2), fp6 = fp2[v]/(v^3+v+1), after the reference's
src/utils/ecc.rs:407-648.
"""
from __future__ import annotations

from ..params.data import P


# --- fp2 = fp[u]/(u^2 - 2u - 2) -------------------------------------------------
def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] + 2 * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0] + 2 * a[1] * b[1]) % P)


# --- fp6 = fp2[v]/(v^3 + v + 1) -------------------------------------------------
F6_ONE = ((1, 0), (0, 0), (0, 0))


def f6_from_limbs(l):
    return ((l[0] % P, l[1] % P), (l[2] % P, l[3] % P), (l[4] % P, l[5] % P))


def f6_to_limbs(a):
    return [a[0][0], a[0][1], a[1][0], a[1][1], a[2][0], a[2][1]]


def f6_scalar(c):
    return ((c % P, 0), (0, 0), (0, 0))


def f6_add(A, B):
    return tuple(f2_add(x, y) for x, y in zip(A, B))


def f6_sub(A, B):
    return tuple(f2_sub(x, y) for x, y in zip(A, B))


def f6_mul(A, B):
    a0, a1, a2 = A
    b0, b1, b2 = B
    aa = f2_mul(a0, b0)
    bb = f2_mul(a1, b1)
    cc = f2_mul(a2, b2)
    c3 = f2_add(f2_mul(a1, b2), f2_mul(a2, b1))
    m1 = f2_add(f2_mul(a0, b1), f2_mul(a1, b0))
    m2 = f2_add(f2_add(f2_mul(a0, b2), f2_mul(a2, b0)), bb)
    # v^3 = -v - 1, v^4 = -v - v^2
    return (f2_sub(aa, c3), f2_sub(f2_sub(m1, c3), cc), f2_sub(m2, cc))


def f6_pow(A, e):
    r = F6_ONE
    while e:
        if e & 1:
            r = f6_mul(r, A)
        A = f6_mul(A, A)
        e >>= 1
    return r


def f6_inv(A):
    return f6_pow(A, P ** 6 - 2)

