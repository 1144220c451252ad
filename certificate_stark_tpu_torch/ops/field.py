"""f63 prime-field arithmetic on torch.int64 tensors.

p = 4719772409484279809 = 2^62 + 2^56 + 2^55 + 1. A field element is the
canonical (< p) Montgomery bit pattern (R = 2^64) of the JAX package's
`[4, ...]` 16-bit-limb arrays (certificate_stark_tpu/ops/field.py), held in
one int64 without the limb axis: JAX `[4, w, n]` is `[w, n]` here. Values
are < 2^63, so never negative.

`mul` is the one operation plain PyTorch cannot express (no 64x64->128
multiply): on a CUDA tensor it launches the f63_mul kernel (ops/kernels.py),
on a CPU tensor it runs the kernel's plain version. add/sub and the rest are
plain int64 tensor ops, written so that no intermediate passes 2^63.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels as K

P = K.P
TWO_ADICITY = 55
R = 1 << 64
R_MOD_P = R % P                      # Montgomery one
R2_MOD_P = (R * R) % P
NPRIME = K.NPRIME


def _generator() -> int:
    """Smallest multiplicative generator (p - 1 = 2^55 * 131)."""
    for cand in range(2, 100):
        if pow(cand, (P - 1) // 2, P) != 1 and pow(cand, (P - 1) // 131, P) != 1:
            return cand
    raise AssertionError("no generator below 100")


GENERATOR = _generator()


# ---------------------------------------------------------------------------
# host conversions (Python ints <-> int64 tensors)
# ---------------------------------------------------------------------------
def mont_int(x: int) -> int:
    """Standard-form int -> its Montgomery representative."""
    return int(x) % P * R % P


def from_ints(values, device) -> torch.Tensor:
    """Standard-form ints (any nesting numpy accepts) -> Montgomery int64
    tensor."""
    arr = np.asarray(values, dtype=object)
    flat = [mont_int(v) for v in arr.ravel()]
    return torch.tensor(np.array(flat, dtype=np.int64).reshape(arr.shape),
                        device=device)


def to_ints(t: torch.Tensor) -> np.ndarray:
    """Montgomery int64 tensor -> numpy object array of standard-form ints."""
    a = from_mont(t).cpu().numpy()
    return np.array([int(v) for v in a.ravel()], dtype=object).reshape(a.shape)


def const(x: int, device) -> torch.Tensor:
    """0-dim Montgomery tensor of one standard-form constant."""
    return torch.tensor(mont_int(x), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------
def add(a, b):
    d = a - (P - b)                           # a + b - p, in (-p, p)
    return torch.where(d < 0, d + P, d)


def sub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    return torch.where(a == 0, a, P - a)


def double(a):
    return add(a, a)


def mul(a, b):
    """Montgomery multiply (broadcasting): REDC(a * b)."""
    if K.use_plain(a):
        return K.mul_plain(a, b)
    a, b = torch.broadcast_tensors(a, b)
    return K.f63_mul(a.contiguous(), b.contiguous())


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a ** e for a fixed Python-int exponent (MSB-first square and
    multiply)."""
    assert e >= 0
    if e == 0:
        return torch.full_like(a, R_MOD_P)
    r = a
    for bit in bin(e)[3:]:
        r = square(r)
        if bit == "1":
            r = mul(r, a)
    return r


def inv(a):
    """Field inverse a^(p-2); 0 maps to 0."""
    return pow_const(a, P - 2)


def batch_inv(a):
    """Elementwise inverse by a product tree (Montgomery's trick, in
    parallel): about 3 multiplies per element and ONE field inversion.
    0 maps to 0, like `inv`."""
    shape = a.shape
    x = a.reshape(-1)
    zero = x == 0
    one = torch.full_like(x, R_MOD_P)
    x = torch.where(zero, one, x)
    levels = []
    cur = x
    while cur.numel() > 1:
        if cur.numel() % 2:
            cur = torch.cat([cur, one[:1]])
        levels.append(cur)
        cur = mul(cur[0::2], cur[1::2])
    inv_cur = inv(cur)
    for lvl in reversed(levels):
        inv_cur = inv_cur[:lvl.numel() // 2]     # drop the padding parent
        out = torch.empty_like(lvl)
        out[0::2] = mul(inv_cur, lvl[1::2])
        out[1::2] = mul(inv_cur, lvl[0::2])
        inv_cur = out
    out = inv_cur[:x.numel()]
    return torch.where(zero, torch.zeros_like(out), out).reshape(shape)


_LO31 = (1 << 31) - 1


def sum(a, dim: int = -1):  # noqa: A001 - the field's sum, like torch.sum
    """Field sum along `dim`: exact int64 sums of the 31-bit halves, then
    one reduction (fewer than 2^31 terms)."""
    assert a.shape[dim] < (1 << 31)
    hi = torch.sum(a >> 31, dim=dim)          # < n * 2^32
    lo = torch.sum(a & _LO31, dim=dim)        # < n * 2^31
    # hi*2^31 + lo mod p; a Montgomery factor 2^31*R turns REDC into *2^31
    hi = torch.remainder(hi, P)
    lo = torch.remainder(lo, P)
    return add(mul(hi, const(1 << 31, a.device)), lo)


def mul_sum(a, b, dim: int):
    """Field sum over `dim` of a * b (broadcasting)."""
    return sum(mul(a, b), dim)


def to_mont(a_std):
    """Standard -> Montgomery form (REDC(a * R^2))."""
    return mul(a_std, torch.tensor(R2_MOD_P, dtype=torch.int64,
                                   device=a_std.device))


def from_mont(a):
    """Montgomery -> standard form (REDC(a * 1))."""
    return mul(a, torch.ones((), dtype=torch.int64, device=a.device))


def powers(base: int, count: int, device) -> torch.Tensor:
    """[base^0 .. base^(count-1)] in Montgomery form [count], by doubling."""
    tbl = const(1, device).reshape(1)
    cur = base % P
    while tbl.numel() < count:
        m = min(tbl.numel(), count - tbl.numel())
        tbl = torch.cat([tbl, mul(tbl[:m], const(cur, device))])
        cur = cur * cur % P
    return tbl[:count]
