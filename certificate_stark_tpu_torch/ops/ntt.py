"""Number-theoretic transform and low-degree extension over f63.

Counterpart of certificate_stark_tpu/ops/ntt.py (`ntt`, `intt`,
`coset_scale`, `lde`): a batched radix-2 decimation-in-time transform over
the last axis, natural order in and out, built from int64 tensor ops around
the field multiply. The values are canonical, so every transform is
bit-identical to the JAX one.
"""
from __future__ import annotations

import torch

from . import field as F

_twiddle_cache: dict = {}
_bitrev_cache: dict = {}


def root_of_unity(n: int) -> int:
    """Standard-form primitive n-th root of unity (n a power of two)."""
    assert n & (n - 1) == 0 and n.bit_length() - 1 <= F.TWO_ADICITY
    return pow(F.GENERATOR, (F.P - 1) // n, F.P)


def twiddles(n: int, device, inverse: bool = False) -> torch.Tensor:
    """[w^0 .. w^(n/2-1)] (w^-1 for the inverse), Montgomery, cached."""
    key = (n, inverse, str(device))
    if key not in _twiddle_cache:
        w = root_of_unity(n)
        if inverse:
            w = pow(w, F.P - 2, F.P)
        _twiddle_cache[key] = F.powers(w, max(n // 2, 1), device)
    return _twiddle_cache[key]


def bitrev_indices(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _bitrev_cache:
        bits = n.bit_length() - 1
        idx = torch.arange(n, device=device)
        rev = torch.zeros_like(idx)
        for b in range(bits):
            rev |= ((idx >> b) & 1) << (bits - 1 - b)
        _bitrev_cache[key] = rev
    return _bitrev_cache[key]


def ntt(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT along the last axis of [..., n] (Montgomery). Forward maps
    coefficients to evaluations at w^0..w^(n-1); the inverse includes 1/n."""
    n = a.shape[-1]
    assert n & (n - 1) == 0
    if n == 1:
        return a.clone()
    lead = tuple(a.shape[:-1])
    master = twiddles(n, a.device, inverse)
    x = a.index_select(-1, bitrev_indices(n, a.device))
    m = 2
    while m <= n:
        half = m // 2
        xr = x.reshape(lead + (n // m, m))
        even, odd = xr[..., :half], xr[..., half:]
        t = F.mul(odd, master[::n // m])
        x = torch.cat([F.add(even, t), F.sub(even, t)], dim=-1)
        m *= 2
    x = x.reshape(lead + (n,))
    if inverse:
        x = F.mul(x, F.const(pow(n, F.P - 2, F.P), a.device))
    return x


def intt(a: torch.Tensor) -> torch.Tensor:
    return ntt(a, inverse=True)


def coset_scale(coeffs: torch.Tensor, offset: int) -> torch.Tensor:
    """Multiply coefficient i by offset^i."""
    return F.mul(coeffs, F.powers(offset, coeffs.shape[-1], coeffs.device))


def lde_from_coeffs(coeffs: torch.Tensor, blowup: int,
                    offset: int) -> torch.Tensor:
    """Coefficients [..., n] -> evaluations over offset*<w_{blowup*n}>."""
    n = coeffs.shape[-1]
    padded = torch.nn.functional.pad(coeffs, (0, (blowup - 1) * n))
    return ntt(coset_scale(padded, offset))


def lde(evals: torch.Tensor, blowup: int, offset: int) -> torch.Tensor:
    """Low-degree extension: evaluations [..., n] over the size-n subgroup
    -> [..., blowup*n] over the coset offset*<w_{blowup*n}>."""
    return lde_from_coeffs(intt(evals), blowup, offset)
