"""FRI commit-phase folding on the device (base field).

Counterpart of certificate_stark_tpu/engine/fri.py `fold2_dyn`/`FriLayer`
and the fold-by-4 layer of `Prover._make_fri_kernel`. One radix-2 fold:

    E'(x^2) = (E(x) + E(-x))/2 + xi * (E(x) - E(-x)) / (2x)

On a domain o*<w> the -x partner of index j is j + n/2, and 1/x comes from
an inverse-powers table. Layer leaves group the `fold` positions that fold
together: leaf j holds the values at j, j + n/fold, j + 2n/fold, ...
"""
from __future__ import annotations

from ..ops import field as F


def inv_xs_table(offset: int, gen: int, count: int, device):
    """[(o*w^j)^-1 for j < count] from powers of w^-1."""
    o_inv = pow(offset, F.P - 2, F.P)
    w_inv = pow(gen, F.P - 2, F.P)
    return F.mul(F.powers(w_inv, count, device), F.const(o_inv, device))


def fold2(evals, xi: int, offset: int, gen: int):
    """One radix-2 fold of [n] evaluations with a standard-form scalar xi
    -> [n/2] over the domain o^2*<w^2>."""
    n = evals.shape[-1]
    half = n // 2
    e0, e1 = evals[..., :half], evals[..., half:]
    inv2 = F.const(pow(2, F.P - 2, F.P), evals.device)
    s = F.mul(F.add(e0, e1), inv2)
    d = F.mul(F.sub(e0, e1), inv2)
    d = F.mul(d, inv_xs_table(offset, gen, half, evals.device))
    d = F.mul(d, F.const(xi, evals.device))
    return F.add(s, d)


def fold(evals, xi: int, offset: int, gen: int, folding: int):
    """Fold by 2, or by 4 as two radix-2 folds with xi and xi^2."""
    out = fold2(evals, xi, offset, gen)
    if folding == 4:
        out = fold2(out, xi * xi % F.P, offset * offset % F.P,
                    gen * gen % F.P)
    return out


class FriLayer:
    def __init__(self, tree, n, offset, gen, group):
        self.tree = tree
        self.n = n
        self.offset = offset
        self.gen = gen
        self.group = group  # [folding, n/folding] evaluations (device)
