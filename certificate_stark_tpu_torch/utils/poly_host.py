"""Host-side (Python int) polynomial helpers for small sizes: periodic-column
interpolation, the roots of unity of the evaluation domains, evaluation and
degree for the verifier. A copy of
certificate_stark_tpu/utils/poly_host.py."""
from __future__ import annotations

from ..ops.field import GENERATOR, P, TWO_ADICITY


def root_of_unity(n: int) -> int:
    assert n & (n - 1) == 0 and n.bit_length() - 1 <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) // n, P)


def ntt(vals, invert=False):
    """Iterative radix-2 NTT on python ints (small n only)."""
    n = len(vals)
    if n == 1:
        return list(vals)
    a = list(vals)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w = pow(root_of_unity(length), P - 2, P) if invert \
            else root_of_unity(length)
        for i in range(0, n, length):
            wn = 1
            for k in range(i, i + length // 2):
                u, v = a[k], a[k + length // 2] * wn % P
                a[k], a[k + length // 2] = (u + v) % P, (u - v) % P
                wn = wn * w % P
        length <<= 1
    if invert:
        n_inv = pow(n, P - 2, P)
        a = [x * n_inv % P for x in a]
    return a


def intt(evals):
    return ntt(evals, invert=True)



def eval_poly(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def poly_degree(coeffs) -> int:
    for i in range(len(coeffs) - 1, -1, -1):
        if coeffs[i] % P != 0:
            return i
    return -1
