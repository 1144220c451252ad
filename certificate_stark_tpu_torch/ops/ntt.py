"""Number-theoretic transform and low-degree extension over f63.

Counterpart of certificate_stark_tpu/ops/ntt.py (`ntt`, `intt`,
`coset_scale`, `lde`): batched transforms over the last axis, natural order
in and out. On the card they are the `ntt` and `lde` kernels
(csrc/ntt.cu, ops/kernels.py); on the CPU, and inside
`kernels.plain_versions()`, their plain versions (a radix-2
decimation-in-time transform of int64 tensor ops, and the LDE by padding,
coset scaling and that transform). The values are canonical, so every
transform is bit-identical to the JAX one.
"""
from __future__ import annotations

import torch

from . import field as F, kernels as K


def root_of_unity(n: int) -> int:
    """Standard-form primitive n-th root of unity (n a power of two)."""
    assert n & (n - 1) == 0 and n.bit_length() - 1 <= F.TWO_ADICITY
    return pow(F.GENERATOR, (F.P - 1) // n, F.P)


def ntt(a: torch.Tensor, inverse: bool = False,
        scale_by=None) -> torch.Tensor:
    """NTT along the last axis of [..., n] (Montgomery). Forward maps
    coefficients to evaluations at w^0..w^(n-1); the inverse includes 1/n,
    and with scale_by value i times scale_by^i (fused into the kernel)."""
    n = a.shape[-1]
    return K.ntt(a.reshape(-1, n).contiguous(), inverse,
                 scale_by).reshape(a.shape)


def intt(a: torch.Tensor, scale_by=None) -> torch.Tensor:
    """Inverse NTT; with scale_by, coefficient i times scale_by^i: with
    scale_by = 1/offset, the coefficients of the polynomial whose values
    over offset * <w_n> are a (coset_scale(intt(a), scale_by) in one
    pass)."""
    return ntt(a, inverse=True, scale_by=scale_by)


def coset_scale(coeffs: torch.Tensor, offset: int) -> torch.Tensor:
    """Multiply coefficient i by offset^i."""
    return F.mul(coeffs, F.powers(offset, coeffs.shape[-1], coeffs.device))


def lde_from_coeffs(coeffs: torch.Tensor, blowup: int,
                    offset: int) -> torch.Tensor:
    """Coefficients [..., n] -> evaluations over offset*<w_{blowup*n}>."""
    n = coeffs.shape[-1]
    out = K.lde(coeffs.reshape(-1, n).contiguous(), blowup, offset)
    return out.reshape(tuple(coeffs.shape[:-1]) + (blowup * n,))


def lde(evals: torch.Tensor, blowup: int, offset: int) -> torch.Tensor:
    """Low-degree extension: evaluations [..., n] over the size-n subgroup
    -> [..., blowup*n] over the coset offset*<w_{blowup*n}>."""
    return lde_from_coeffs(intt(evals), blowup, offset)
