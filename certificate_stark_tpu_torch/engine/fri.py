"""FRI commit-phase folding on the device.

Counterpart of certificate_stark_tpu/engine/fri.py `fold2_ext`/`FriLayer`
and the fold-by-4 layer of `Prover._make_fri_kernel`. The evaluations are
extension values [d, n] (d = 1 for base-field proofs) and the folding
scalar xi an extension element. One radix-2 fold:

    E'(x^2) = (E(x) + E(-x))/2 + xi * (E(x) - E(-x)) / (2x)

On a domain o*<w> the -x partner of index j is j + n/2. A fold by 4 is two
radix-2 folds, with xi and xi^2. Layer leaves group the `fold` positions
that fold together, element-major: leaf j holds the d coordinates of the
value at j, then of the value at j + n/fold, j + 2n/fold, ... (the JAX
package's `commit_kernel`): `leaf_rows`. Only the first layer's rows are
made by it, from the DEEP values; `fold` is one launch of the fri_fold
kernel (ops/kernels.py), which reads a layer's rows and writes the next
layer's rows itself, or, at the last layer, the remainder's values. Its
plain version takes its steps from `inv_xs_table` (1/x from an
inverse-powers table) and `fold_halves`. `plan` works out each layer's
constants once a prover.
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


def plan(size: int, offset: int, gen: int, opts, device) -> list:
    """The FRI layers of a domain of `size` points on offset * <gen>, down
    to opts.fri_max_remainder values: a K.FoldLayer each."""
    fold, out = opts.fri_folding, []
    while size > opts.fri_max_remainder:
        out.append(K.FoldLayer(offset, gen, size, fold, device))
        size //= fold
        offset, gen = pow(offset, fold, F.P), pow(gen, fold, F.P)
    return out


def fold(rows, xi, layer, out_fold: int = 0):
    """Fold a layer from its leaf rows [fold d, n/fold] (`layer` its
    K.FoldLayer, xi the coin's d ints): one fri_fold launch -> the next
    layer's leaf rows [out_fold d, n/(fold out_fold)], or with out_fold 0
    its values [d, n/fold]."""
    return K.fri_fold(rows.reshape(layer.fold, -1, rows.shape[-1]), xi,
                      layer, out_fold=out_fold)


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
