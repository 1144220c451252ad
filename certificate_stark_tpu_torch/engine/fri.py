"""FRI commit-phase folding on the device.

Counterpart of certificate_stark_tpu/engine/fri.py `fold2_ext`/`FriLayer`
and the fold-by-4 layer of `Prover._make_fri_kernel`. The evaluations are
extension values [d, n] (d = 1 for base-field proofs) and the folding
scalar xi an extension element. One radix-2 fold:

    E'(x^2) = (E(x) + E(-x))/2 + xi * (E(x) - E(-x)) / (2x)

On a domain o*<w> the -x partner of index j is j + n/2. A fold by 4 is two
radix-2 folds, with xi and xi^2: `fold` is one launch of the fri_fold
kernel (ops/kernels.py), whose plain version takes its steps from
`inv_xs_table` (1/x from an inverse-powers table) and `fold_halves`. Layer
leaves group the `fold` positions that fold together, element-major: leaf
j holds the d coordinates of the value at j, then of the value at j +
n/fold, j + 2n/fold, ...
"""
from __future__ import annotations

from ..ops import extfield as XF, field as F, kernels as K


def inv_xs_table(offset: int, gen: int, count: int, device):
    """[(o*w^j)^-1 for j < count] from powers of w^-1."""
    o_inv = pow(offset, F.P - 2, F.P)
    w_inv = pow(gen, F.P - 2, F.P)
    return F.mul(F.powers(w_inv, count, device), F.const(o_inv, device))


def fold_halves(e0, e1, inv_x, xi):
    """The radix-2 fold of the values e0 at x and e1 at -x [d, *S], with
    inv_x [*S] = 1/x and the extension scalar xi [d] (Montgomery)."""
    d = e0.shape[0]
    inv2 = F.const(pow(2, F.P - 2, F.P), e0.device)
    s = F.mul(F.add(e0, e1), inv2)
    t = F.mul(F.sub(e0, e1), F.mul(inv_x, inv2))
    return F.add(s, XF.ext_mul(t, xi.reshape((d,) + (1,) * (t.dim() - 1)),
                               d))


def fold(evals, xi, offset: int, gen: int, folding: int):
    """Fold [d, n] by 2, or by 4 as two radix-2 folds with xi and xi^2:
    one fri_fold launch on the values at j + t n/folding."""
    d, n = evals.shape
    return K.fri_fold(evals.reshape(d, folding, n // folding)
                      .transpose(0, 1), xi, offset, gen)


def leaf_rows(evals, folding: int):
    """[d, n] -> the layer's leaf rows [folding * d, n / folding],
    element-major."""
    d, n = evals.shape
    return evals.reshape(d, folding, n // folding).permute(1, 0, 2) \
        .reshape(folding * d, n // folding)


class FriLayer:
    def __init__(self, tree, n, offset, gen, group):
        self.tree = tree
        self.n = n
        self.offset = offset
        self.gen = gen
        self.group = group  # leaf rows [folding * d, n/folding] (device)
