"""Quadratic and cubic extension fields over f63 (towers in
params/extensions.py).

Counterpart of certificate_stark_tpu/ops/extfield.py. A device element is an
int64 Montgomery tensor [d, *S] with the extension coordinate on the leading
axis (the JAX package's [4, d, *S] without the limb axis). The composition
randomness, the OOD point z, DEEP and FRI live in the extension; the trace
and the constraint evaluations stay in the base field.

An extension multiply stacks all its base products into one field multiply
(one `f63_mul` launch on the card), as ops/ecc.py does for fp6. The tower
constants are small (3 and 1), so their products are sums. The host
functions work on lists of d standard-form Python ints, for the verifier.
"""
from __future__ import annotations

import torch

from . import field as F
from ..params import extensions as X


def _scale(t, c: int):
    """c * t for a small non-negative integer c, by doubling and adding."""
    out = None
    for bit in bin(c)[2:]:
        if out is not None:
            out = F.double(out)
        if bit == "1":
            out = t if out is None else F.add(out, t)
    return torch.zeros_like(t) if out is None else out


def _operands(a, degree: int):
    """The Karatsuba operands of a [d, *S]: (a0, a1, a0+a1) for d = 2;
    (a0, a1, a2, a0+a1, a1+a2, a0+a2) for d = 3."""
    if degree == 2:
        return torch.cat([a, F.add(a[0:1], a[1:2])])
    return torch.cat([a, F.add(a[[0, 1, 0]], a[[1, 2, 2]])])


def _combine(prod, degree: int):
    """The coordinates of the product from its Karatsuba partial products
    (prod [3 or 6, *S], or their sums)."""
    if degree == 2:
        u, v, w = prod[0], prod[1], prod[2]
        c0 = F.add(u, _scale(v, X.QUAD_NONRESIDUE))
        c1 = F.sub(F.sub(w, u), v)                     # a0b1 + a1b0
        return torch.stack([c0, c1])
    v0, v1, v2, v01, v12, v02 = (prod[i] for i in range(6))
    c1p = F.sub(F.sub(v01, v0), v1)                    # a0b1 + a1b0
    c3 = F.sub(F.sub(v12, v1), v2)                     # a1b2 + a2b1
    c2p = F.add(F.sub(F.sub(v02, v0), v2), v1)         # a0b2 + a2b0 + a1b1
    c4 = v2
    # x^3 = A1 x + A0 ; x^4 = A1 x^2 + A0 x
    c0 = F.add(v0, _scale(c3, X.CUBIC_A0))
    c1 = F.add(F.add(c1p, _scale(c3, X.CUBIC_A1)), _scale(c4, X.CUBIC_A0))
    c2 = F.add(c2p, _scale(c4, X.CUBIC_A1))
    return torch.stack([c0, c1, c2])


def e2_mul(a, b):
    """(a0 + a1 x)(b0 + b1 x) with x^2 = 3: [2, *S] (broadcasting)."""
    return _combine(F.mul(_operands(a, 2), _operands(b, 2)), 2)


def e3_mul(a, b):
    """(a0 + a1 x + a2 x^2)(b0 + b1 x + b2 x^2) with x^3 = 3x + 1."""
    return _combine(F.mul(_operands(a, 3), _operands(b, 3)), 3)


def ext_mul(a, b, degree: int):
    """Extension product of [d, *S] tensors (broadcasting)."""
    if degree == 1:
        return F.mul(a, b)
    return e2_mul(a, b) if degree == 2 else e3_mul(a, b)


def ext_mul_sum(a, b, degree: int, dim: int):
    """Sum over axis `dim` (an axis of [d, *S], not the extension axis 0)
    of ext_mul(a, b): the partial products are summed before they are
    combined (the combination is linear)."""
    assert dim not in (0, -max(a.dim(), b.dim()))
    if degree == 1:
        return F.mul_sum(a, b, dim)
    return _combine(F.sum(F.mul(_operands(a, degree), _operands(b, degree)),
                          dim), degree)


def base_to_ext(a, degree: int):
    """Base elements [*S] -> [d, *S] with zero high coordinates."""
    return torch.cat([a[None], torch.zeros((degree - 1,) + tuple(a.shape),
                                           dtype=a.dtype, device=a.device)])


def ext_inv_vec(a, degree: int):
    """Elementwise extension inverse of [d, *S] (0 maps to 0): the inverse
    of the norm (one base batch inversion) times the adjugate column, by
    Cramer's rule on the multiplication matrix."""
    if degree == 1:
        return F.batch_inv(a)
    a0, a1 = a[0], a[1]
    if degree == 2:
        sq = F.mul(a, a)
        t = F.batch_inv(F.sub(sq[0], _scale(sq[1], X.QUAD_NONRESIDUE)))
        return F.mul(torch.stack([a0, F.neg(a1)]), t)
    a2 = a[2]
    # multiplication matrix [[a0, m12, m13], [a1, m11, m23], [a2, a1, m11]]
    m11 = F.add(a0, _scale(a2, X.CUBIC_A1))
    m12 = _scale(a2, X.CUBIC_A0)
    m13 = _scale(a1, X.CUBIC_A0)
    m23 = F.add(m12, _scale(a1, X.CUBIC_A1))
    p = F.mul(torch.stack([m11, m23, a1, m23, a1, m11]),
              torch.stack([m11, a1, m11, a2, a1, a2]))
    # cofactors of the first row: M^-1 e0 = (c00, c01, c02) / det
    c = torch.stack([F.sub(p[0], p[1]), F.sub(p[3], p[2]),
                     F.sub(p[4], p[5])])
    q = F.mul(torch.stack([a0, m12, m13]), c)
    det = F.add(F.add(q[0], q[1]), q[2])
    return F.mul(c, F.batch_inv(det))


def ext_powers_dyn(z, count: int, degree: int):
    """[z^0 .. z^(count-1)] of extension scalars z [d, *S] -> [d, *S, count],
    by doubling the table (one extension multiply a step)."""
    one = base_to_ext(F.const(1, z.device).expand(z.shape[1:]), degree)
    tbl = one[..., None]
    zz = z[..., None]
    while tbl.shape[-1] < count:
        m = min(tbl.shape[-1], count - tbl.shape[-1])
        tbl = torch.cat([tbl, ext_mul(tbl[..., :m], zz, degree)], dim=-1)
        zz = ext_mul(zz, zz, degree)
    return tbl[..., :count]


def from_ints(vals, degree: int, device):
    """Extension elements as lists of d standard-form ints -> [d, len]."""
    return F.from_ints([list(v) for v in vals],
                       device).reshape(-1, degree).T.contiguous()


def flat_ints(t) -> list:
    """[d, *S] device extension values -> flat standard-form ints,
    element-major (the element outer, its coordinates inner), as proofs
    carry them."""
    return [int(v) for v in F.to_ints(t.reshape(t.shape[0], -1).T).ravel()]


# ---------------------------------------------------------------------------
# host (Python-int) mirrors, for the verifier
# ---------------------------------------------------------------------------
def host_e2_mul(a, b):
    P = F.P
    return [(a[0] * b[0] + X.QUAD_NONRESIDUE * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P]


def host_e3_mul(a, b):
    P = F.P
    c = [0] * 5
    for i in range(3):
        for j in range(3):
            c[i + j] = (c[i + j] + a[i] * b[j]) % P
    # x^3 = A1 x + A0 ; x^4 = A1 x^2 + A0 x
    return [(c[0] + X.CUBIC_A0 * c[3]) % P,
            (c[1] + X.CUBIC_A1 * c[3] + X.CUBIC_A0 * c[4]) % P,
            (c[2] + X.CUBIC_A1 * c[4]) % P]


def host_ext_mul(a, b, degree):
    if degree == 1:
        return [(a[0] * b[0]) % F.P]
    return host_e2_mul(a, b) if degree == 2 else host_e3_mul(a, b)


def host_ext_inv(a, degree):
    """Inverse by Gaussian elimination on the multiplication matrix."""
    P = F.P
    if degree == 1:
        return [pow(a[0], P - 2, P)]
    cols = []
    for i in range(degree):
        e = [0] * degree
        e[i] = 1
        cols.append(host_ext_mul(a, e, degree))
    m = [[cols[j][i] for j in range(degree)] for i in range(degree)]
    rhs = [1] + [0] * (degree - 1)
    for col in range(degree):
        piv = next(r for r in range(col, degree) if m[r][col] % P)
        m[col], m[piv] = m[piv], m[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = pow(m[col][col], P - 2, P)
        m[col] = [v * inv % P for v in m[col]]
        rhs[col] = rhs[col] * inv % P
        for r in range(degree):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [(m[r][j] - f * m[col][j]) % P for j in range(degree)]
                rhs[r] = (rhs[r] - f * rhs[col]) % P
    return rhs
