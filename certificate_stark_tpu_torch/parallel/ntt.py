"""The six-step NTT over the ranks of a Mesh.

Counterpart of certificate_stark_tpu/parallel/ntt.py (`_twiddle_matrix`,
`ntt_sharded`, :26-93). N = n1 * n2 with n1 = 2^floor(log2 N / 2); with
x[i1, i2] = x[i1 * n2 + i2],

    X[k2 * n1 + k1] = DFT_n2( w^(i2 * k1) * DFT_n1(x[:, i2])[k1] )[k2]

Input and output are [*B, N/D] blocks of the last axis in natural order
(rank r holds indices [r * N/D, (r+1) * N/D)). Three all-to-alls a
transform move the blocks from i1-rows to i2-columns, from i2 to k1 and
from k1 to k2; the local transforms are the port's ops/ntt.py `ntt` (the
ntt kernel on the card, on a contiguous copy of each transposed view) and
the twiddle multiply `F.mul` (the f63_mul kernel on the card). Each local
inverse transform scales by 1/n1 or 1/n2, together 1/N.
"""
from __future__ import annotations

import torch

from ..ops import field as F, ntt as NTT

_twiddle_cache: dict = {}


def split(n: int):
    """(n1, n2) of the six-step factorization of n."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def splits(n: int, d: int) -> bool:
    """Whether n factors across d ranks (n1 and n2 multiples of d)."""
    n1, n2 = split(n)
    return n1 % d == 0 and n2 % d == 0


def twiddles(n: int, d: int, rank: int, inverse: bool, device):
    """This rank's rows of the twiddle table: w^(i2 * k1) for i2 in
    [rank * n2/d, (rank+1) * n2/d) and every k1 < n1 -> [n2/d, n1]
    (w^-1 for the inverse), by doubling along k1; cached."""
    key = (n, d, rank, inverse, str(device))
    if key not in _twiddle_cache:
        n1, n2 = split(n)
        w = NTT.root_of_unity(n)
        if inverse:
            w = pow(w, F.P - 2, F.P)
        rows = n2 // d
        col = F.mul(F.powers(w, rows, device),                   # w^i2
                    F.const(pow(w, rank * rows, F.P), device))[:, None]
        tbl = torch.full((rows, 1), F.R_MOD_P, dtype=torch.int64,
                         device=device)
        while tbl.shape[1] < n1:            # tbl[:, m:2m] = tbl[:, :m] * w^(i2 m)
            tbl = torch.cat([tbl, F.mul(tbl, col)], dim=1)
            col = F.mul(col, col)
        _twiddle_cache[key] = tbl
    return _twiddle_cache[key]


def _exchange(mesh, y, a: int, b: int):
    """[*B, a, b * D] with its last axis split over the ranks by blocks of
    b -> [*B, a * D, b]: block s of the last axis goes to rank s, and the
    blocks received stack along the second-to-last axis in rank order."""
    D = mesh.size
    lead = tuple(y.shape[:-2])
    nb = len(lead)
    send = y.reshape(lead + (a, D, b)).permute(
        (nb + 1,) + tuple(range(nb)) + (nb, nb + 2))       # [D, *B, a, b]
    got = mesh.all_to_all(send)                            # [D, *B, a, b]
    return got.permute(tuple(range(1, nb + 1)) + (0, nb + 1, nb + 2)) \
        .reshape(lead + (a * D, b))


def ntt_sharded(mesh, x, n: int, inverse: bool = False):
    """The NTT of length n over the last axis of the distributed [*B, n]
    array whose block [*B, n/D] this rank holds in x -> this rank's block
    of the transform, natural order (the inverse includes 1/n)."""
    D = mesh.size
    n1, n2 = split(n)
    if not splits(n, D):
        raise ValueError(f"n = {n} = {n1} x {n2} does not split over {D} "
                         "ranks")
    assert x.shape[-1] == n // D, (tuple(x.shape), n, D)
    lead = tuple(x.shape[:-1])
    # rows i1 of this block, all i2 -> all i1, the block's i2 columns
    y = _exchange(mesh, x.reshape(lead + (n1 // D, n2)), n1 // D, n2 // D)
    y = NTT.ntt(y.transpose(-1, -2), inverse=inverse)      # [*B, n2/D, n1]
    y = F.mul(y, twiddles(n, D, mesh.rank, inverse, x.device))
    # i2 block, all k1 -> all i2, the block's k1
    z = _exchange(mesh, y, n2 // D, n1 // D)               # [*B, n2, n1/D]
    z = NTT.ntt(z.transpose(-1, -2), inverse=inverse)      # [*B, n1/D, n2]
    # k1 block, all k2 -> all k1, the block's k2; X[k2 * n1 + k1]
    u = _exchange(mesh, z, n1 // D, n2 // D)               # [*B, n1, n2/D]
    return u.transpose(-1, -2).reshape(lead + (n // D,))
