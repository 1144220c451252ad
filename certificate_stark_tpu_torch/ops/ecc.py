"""fp6 tower and Cheetah-curve point ops for constraint evaluation, generic
over the field facade fx (engine/fieldops.py) on int64 tensors
[..., coord, B]: the fp6-coordinate axis is second to last.

Counterpart of certificate_stark_tpu/ops/ecc.py (:95-405) without the limb
axis. An fp6 multiply batches the 18 base-field products of its six
Karatsuba fp2 multiplies into one field multiply, and forms its operands
and its result with a few stacked additions, not one per coordinate. The
port's values are canonical, so any order of field operations gives the
same bits, and the JAX package's deferred-REDC fp6 multiply has no
counterpart.

Formulas mirror reference src/utils/ecc.rs (fp2 = fp[u]/(u^2-2u-2),
fp6 = fp2[v]/(v^3+v+1); RCB-style complete addition for y^2 = x^3 + x + b).
The curve constant b3 = 3b is passed as its 6 standard-form coordinates
(utils/curve.py B3_LIMBS), so the multiply by it is chosen on the host.
Arrays are built and joined only through the facade, so the same code runs
on device tensors (BASE) and on the verifier's host arrays (HostExtOps).
"""
from __future__ import annotations

from . import field as F


def _cat(fx, parts):
    return fx.cat(parts, -2)


def _karatsuba_operands(fx, x):
    """[..., 6, B] fp6 -> [..., 6, 2, B]: the fp2 operands (x0, x1, x2,
    x0+x1, x0+x2, x1+x2) of the six Karatsuba fp2 multiplies."""
    x3 = x.reshape(x.shape[:-2] + (3, 2) + x.shape[-1:])
    sums = fx.add(x3[..., [0, 0, 1], :, :], x3[..., [1, 2, 2], :, :])
    return fx.cat([x3, sums], -3)


def f6_mul(fx, a, b):
    """fp6 multiply: a, b [..., 6, B] -> [..., 6, B]. The six fp2 products
    are one stacked field multiply of their 18 base products (u, v, w of
    each: c0 = u + 2v, c1 = v + c0 + w)."""
    xa, xb = _karatsuba_operands(fx, a), _karatsuba_operands(fx, b)
    a0, a1 = xa[..., 0, :], xa[..., 1, :]                   # [..., 6, B]
    b0, b1 = xb[..., 0, :], xb[..., 1, :]
    prod = fx.mul(_cat(fx, [a0, a1, fx.sub(a0, a1)]),
                  _cat(fx, [b0, b1, fx.sub(b1, b0)]))       # [..., 18, B]
    u, v, w = prod[..., 0:6, :], prod[..., 6:12, :], prod[..., 12:18, :]
    c0 = fx.add(u, fx.add(v, v))
    c1 = fx.add(fx.add(v, c0), w)
    r = fx.stack([c0, c1], -2)                               # [..., 6, 2, B]
    aa, bb, cc, ab, ac, bc = (r[..., k, :, :] for k in range(6))
    tmp = fx.add(fx.add(aa, bb), cc)
    c0 = fx.sub(tmp, bc)
    c1 = fx.sub(fx.sub(ab, bc), aa)
    c2 = fx.add(fx.sub(fx.sub(ac, tmp), cc), fx.add(bb, bb))
    return _cat(fx, [c0, c1, c2])


def f2_mul(fx, a, b):
    """fp2 multiply on [..., 2, B] (u^2 = 2u + 2)."""
    a0, a1 = a[..., 0:1, :], a[..., 1:2, :]
    b0, b1 = b[..., 0:1, :], b[..., 1:2, :]
    prod = fx.mul(_cat(fx, [a0, a1, fx.sub(a0, a1)]),
                  _cat(fx, [b0, b1, fx.sub(b1, b0)]))
    u, v, w = prod[..., 0:1, :], prod[..., 1:2, :], prod[..., 2:3, :]
    c0 = fx.add(u, fx.add(v, v))
    return _cat(fx, [c0, fx.add(fx.add(v, c0), w)])


def f2_inv(fx, a):
    """fp2 inverse via the conjugate norm (ecc.rs:442-446)."""
    a0, a1 = a[..., 0:1, :], a[..., 1:2, :]
    norm = fx.sub(fx.add(fx.mul(a0, a0),
                         fx.add(fx.mul(a0, a1), fx.mul(a0, a1))),
                  fx.double(fx.mul(a1, a1)))
    t = fx.inv(norm)
    c0 = fx.mul(fx.add(a0, fx.double(a1)), t)
    c1 = fx.neg(fx.mul(a1, t))
    return _cat(fx, [c0, c1])


def f6_inv(fx, a):
    """fp6 inverse (reference invert_fp6 sequence, ecc.rs:551-591)."""
    c0_, c1_, c2_ = a[..., 0:2, :], a[..., 2:4, :], a[..., 4:6, :]
    m = lambda u, v: f2_mul(fx, u, v)
    ad, sb, dbl = fx.add, fx.sub, fx.double

    c0_sq = m(c0_, c0_)
    c1_sq = m(c1_, c1_)
    c2_sq = m(c2_, c2_)
    t = m(c0_, ad(c0_sq, c1_sq))
    t = sb(t, m(c1_, c1_sq))
    tmp = ad(c0_, sb(c2_, c1_))
    t = ad(t, m(tmp, c2_sq))
    tmp = ad(dbl(c0_), c0_)
    tmp = m(tmp, c1_)
    tmp = sb(dbl(c0_sq), tmp)
    tmp = m(tmp, c2_)
    t = sb(t, tmp)
    t = f2_inv(fx, t)

    r0 = ad(ad(c0_sq, c1_sq), c2_sq)
    tmp = sb(dbl(c0_), c1_)
    tmp = m(tmp, c2_)
    r0 = m(sb(r0, tmp), t)
    r1 = fx.neg(m(ad(m(c0_, c1_), c2_sq), t))
    r2 = m(ad(sb(c1_sq, m(c0_, c2_)), c2_sq), t)
    return _cat(fx, [r0, r1, r2])


def _mul_b3(fx, b3, t):
    """b3 * t in fp6, b3 given by 6 standard-form ints. A base-subfield
    scalar (coordinates 1..5 zero) takes 6 base multiplies; an fp2 scalar
    (coordinates 2..5 zero) 9, as three fp2 multiplies; any other value
    the 18-multiply Karatsuba."""
    b3 = [int(v) % F.P for v in b3]
    if not any(b3[1:]):
        return fx.mul(t, fx.const(b3[0], t))
    if not any(b3[2:]):
        # fp2 multiply by (s0, s1) per fp6 coordinate (ecc.rs:424-439):
        # c0 = u + 2v, c1 = v + c0 + w with u = x0*s0, v = x1*s1,
        # w = (x0-x1)(s1-s0)
        s0, s1 = b3[0], b3[1]
        rhs = fx.embed([s0] * 3 + [s1] * 3 + [(s1 - s0) % F.P] * 3,
                       t)                                         # [9, 1]
        x0, x1 = t[..., 0::2, :], t[..., 1::2, :]
        prod = fx.mul(_cat(fx, [x0, x1, fx.sub(x0, x1)]), rhs)
        u, v, w = prod[..., 0:3, :], prod[..., 3:6, :], prod[..., 6:9, :]
        c0 = fx.add(u, fx.add(v, v))
        c1 = fx.add(fx.add(v, c0), w)
        out = fx.stack([c0, c1], -2)             # [..., 3, 2, B] pair-major
        return out.reshape(out.shape[:-3] + (6,) + out.shape[-1:])
    return f6_mul(fx, fx.embed(b3, t), t)


# ---------------------------------------------------------------------------
# point ops on stacked projective points [..., 18, B] (X||Y||Z), mirroring
# the exact mul/add sequences of ecc.rs (formula-identical intermediates)
# ---------------------------------------------------------------------------
def compute_double(fx, pt, b3):
    x, y, z = pt[..., 0:6, :], pt[..., 6:12, :], pt[..., 12:18, :]
    m = lambda u, v: f6_mul(fx, u, v)
    a, s, d = fx.add, fx.sub, (lambda u: fx.add(u, u))

    t0 = m(x, x)
    t1 = m(y, y)
    t2 = m(z, z)
    t3 = d(m(x, y))
    z3 = d(m(x, z))
    y3 = _mul_b3(fx, b3, t2)
    y3 = a(z3, y3)
    x3 = s(t1, y3)
    y3 = a(t1, y3)
    y3 = m(x3, y3)
    x3 = m(t3, x3)
    z3 = _mul_b3(fx, b3, z3)
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
    return _cat(fx, [x3, y3, z3])


def compute_add(fx, pt1, pt2, b3):
    x1, y1, z1 = pt1[..., 0:6, :], pt1[..., 6:12, :], pt1[..., 12:18, :]
    x2, y2, z2 = pt2[..., 0:6, :], pt2[..., 6:12, :], pt2[..., 12:18, :]
    m = lambda u, v: f6_mul(fx, u, v)
    a, s, d = fx.add, fx.sub, (lambda u: fx.add(u, u))

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t2 = m(z1, z2)
    t3 = s(m(a(x1, y1), a(x2, y2)), a(t0, t1))
    t4 = s(m(a(x1, z1), a(x2, z2)), a(t0, t2))
    t5 = s(m(a(y1, z1), a(y2, z2)), a(t1, t2))
    x3 = _mul_b3(fx, b3, t2)
    z3 = a(x3, t4)
    x3 = s(t1, z3)
    z3 = a(t1, z3)
    y3 = m(x3, z3)
    t1 = a(d(t0), t0)
    t4 = _mul_b3(fx, b3, t4)
    t1 = a(t1, t2)
    t2 = s(t0, t2)
    t4 = a(t4, t2)
    t0 = m(t1, t4)
    y3 = a(y3, t0)
    t0 = m(t5, t4)
    x3 = s(m(t3, x3), t0)
    t0 = m(t3, t1)
    z3 = a(m(t5, z3), t0)
    return _cat(fx, [x3, y3, z3])


def compute_add_mixed(fx, pt1, pt2_affine, b3):
    x1, y1, z1 = pt1[..., 0:6, :], pt1[..., 6:12, :], pt1[..., 12:18, :]
    x2, y2 = pt2_affine[..., 0:6, :], pt2_affine[..., 6:12, :]
    m = lambda u, v: f6_mul(fx, u, v)
    a, s, d = fx.add, fx.sub, (lambda u: fx.add(u, u))

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t3 = s(m(a(x2, y2), a(x1, y1)), a(t0, t1))
    t4 = a(m(x2, z1), x1)
    t5 = a(m(y2, z1), y1)
    x3 = _mul_b3(fx, b3, z1)
    z3 = a(x3, t4)
    x3 = s(t1, z3)
    z3 = a(t1, z3)
    y3 = m(x3, z3)
    t1 = a(d(t0), t0)
    t4 = _mul_b3(fx, b3, t4)
    t1 = a(t1, z1)
    t2 = s(t0, z1)
    t4 = a(t4, t2)
    t0 = m(t1, t4)
    y3 = a(y3, t0)
    t0 = m(t5, t4)
    x3 = s(m(t3, x3), t0)
    t0 = m(t3, t1)
    z3 = a(m(t5, z3), t0)
    return _cat(fx, [x3, y3, z3])


# ---------------------------------------------------------------------------
# constraint evaluators (ecc.rs:73-172); results stacked [..., 19, B] or
# [..., 18, B]: the caller aggregates them into its result slots
# ---------------------------------------------------------------------------
def enforce_point_doubling(fx, cur19, nxt19, flag, b3):
    """19 constraint rows: 18 doubling equalities + 1 binary bit check."""
    dbl = compute_double(fx, cur19[..., 0:18, :], b3)
    eqs = fx.mul(fx.sub(nxt19[..., 0:18, :], dbl), flag)
    bit = cur19[..., 18:19, :]
    binc = fx.mul(fx.sub(fx.mul(bit, bit), bit), flag)
    return _cat(fx, [eqs, binc])


def enforce_point_addition_mixed(fx, cur19, nxt19, point12, flag, b3):
    """19 rows: conditional-add equalities + bit-copy check."""
    added = compute_add_mixed(fx, cur19[..., 0:18, :], point12, b3)
    bit = cur19[..., 18:19, :]
    not_bit = fx.sub(fx.const(1, bit), bit)
    expect = fx.add(fx.mul(added, bit), fx.mul(cur19[..., 0:18, :], not_bit))
    eqs = fx.mul(fx.sub(nxt19[..., 0:18, :], expect), flag)
    bitcopy = fx.mul(fx.sub(cur19[..., 18:19, :], nxt19[..., 18:19, :]), flag)
    return _cat(fx, [eqs, bitcopy])


def enforce_point_addition_reduce_x(fx, cur18, nxt18, point18, flag, b3):
    """18 rows: full addition with affine-x reduction on the first 6
    (x * Z == X check), plus Y/Z equalities."""
    added = compute_add(fx, cur18, point18, b3)
    x_z = f6_mul(fx, nxt18[..., 0:6, :], added[..., 12:18, :])
    first = fx.sub(x_z, added[..., 0:6, :])
    rest = fx.sub(nxt18[..., 6:18, :], added[..., 6:18, :])
    return fx.mul(_cat(fx, [first, rest]), flag)
