"""The FRI fold's leaf-row output and the fri_fold kernel's formula, on the
CPU (ops/kernels.py `fri_fold`, csrc/deep.cu, engine/fri.py,
engine/prover.py `_fri_layers`):

- the plain fold in both output modes, the values [d, L] and the next
  layer's leaf rows [fold d, L / fold], at d = 2, 3 (d = 1 in
  tests/test_torch_deep.py): fold 2 against the JAX package's
  engine/fri.py `fold2_ext` (one compile a degree, at 64 points), fold 4
  against a host fold, fold2_ext's formula in Python ints with the JAX
  package's `host_ext_mul`, applied twice with xi^2 (it equals fold2_ext
  on the same inputs); the rows laid out as the JAX prover's
  `commit_kernel` lays them, rows of 2 .. 16 points (below a warp's 32);
- a Python-int model of the kernel's formula, in the CUDA code's order of
  operations on Montgomery patterns (one 1/fold at the end instead of a
  halving a radix-2 fold; xi and xi^2 once a layer, their multiplication
  matrices built as the kernel builds them), against JAX's `fold4_host`
  (d = 1) and the host fold (d = 1, 2, 3) at random points and on p - 1;
- the prover's FRI loop: leaf_rows only on the DEEP values of the first
  layer, each later layer's rows the fold's own output.

The bytes of whole proofs through the new loop are held by the goldens of
tests/test_torch_extension_proofs.py (`transaction_2tx_d3_cubic_blake3`
among them), tests/test_torch_sharded_prover.py (the sharded layers and
the replicated tail) and the other proof tests. The kernel itself runs
only on the card, where chip_smoke.py holds it bit for bit against the
plain version in both output modes. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import fri as JFRI
from certificate_stark_tpu.ops import extfield as JXF
from certificate_stark_tpu.utils import poly_host as JPH
from certificate_stark_tpu_torch.engine import fri as FRI
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

P = F.P
R_INV = pow(1 << 64, P - 2, P)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs a worker process per core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(rng, *shape):
    """Uniform field elements (Montgomery patterns) from a numpy seed."""
    return torch.from_numpy(rng.integers(0, P, size=shape, dtype=np.uint64)
                            .astype(np.int64))


def _jax(t):
    return jnp.asarray(to_jax_limbs(t))


N = 64           # layer points: rows of 2 .. 16 points


def _mont(x):
    return (x << 64) % P


def _host_fold2(ev, xi, o, gw, d):
    """fold2_ext in Python ints: ev [d][n] and xi [d] standard-form, the
    layer on o * <gw> -> [d][n / 2], (e0 + e1) / 2 + xi (e0 - e1) / (2x)
    with JAX's host_ext_mul."""
    half, inv2 = len(ev[0]) // 2, pow(2, P - 2, P)
    out = [[0] * half for _ in range(d)]
    for j in range(half):
        ix = pow(o * pow(gw, j, P) % P, P - 2, P)
        e0, e1 = [ev[e][j] for e in range(d)], [ev[e][j + half]
                                                for e in range(d)]
        t = JXF.host_ext_mul([(a - b) * inv2 * ix % P
                              for a, b in zip(e0, e1)], xi, d)
        for e in range(d):
            out[e][j] = ((e0[e] + e1[e]) * inv2 + t[e]) % P
    return out


def _host_folds(ev, xi, d):
    """{fold: the layer of N points on GENERATOR * <w_N> folded}: the host
    fold once (fold 2), and again with xi^2 on the squared domain (fold
    4); Montgomery int64 tensors."""
    o, gw = F.GENERATOR, JPH.root_of_unity(N)
    once = _host_fold2(ev, xi, o, gw, d)
    twice = _host_fold2(once, JXF.host_ext_mul(xi, xi, d), o * o % P,
                        gw * gw % P, d)
    return {2: F.from_ints(once, "cpu"), 4: F.from_ints(twice, "cpu")}


def _inputs(d):
    """[(values [d, N], xi as the coin draws it)] on seeded random values
    and on p - 1 everywhere."""
    rng = np.random.default_rng(100 + d)
    return [(_rand(rng, d, N), F.to_ints(_rand(rng, d)).tolist()),
            (F.from_ints([[P - 1] * N] * d, "cpu"), [P - 1] * d)]


def _leaf_rows(vals, f):
    """The JAX prover's commit_kernel layout of vals [d, size] (element-
    major leaves of the f values that fold together) -> [f d, size / f]."""
    d, size = vals.shape
    return vals.reshape(d, f, size // f).transpose(0, 1).reshape(f * d, -1)


@pytest.mark.parametrize("d", [2, 3])
def test_plain_fold_rows_equal_jax(d):
    """Both output modes, fold 2 (from the strided values, as the sharded
    prover's blocks fold) and 4 (from the leaf rows, as the prover folds):
    fold 2 against fold2_ext, which the host fold equals; fold 4 against
    the host fold twice."""
    o, gw = F.GENERATOR, JPH.root_of_unity(N)
    for evals, xi in _inputs(d):
        exp = _host_folds(F.to_ints(evals).tolist(), xi, d)
        jax_once = from_jax_limbs(np.asarray(JFRI.fold2_ext(
            _jax(evals), _jax(F.from_ints(xi, "cpu")), o, gw, d)))
        assert torch.equal(jax_once, exp[2])
        for fold in (2, 4):
            layer = K.FoldLayer(o, gw, N, fold, "cpu")
            src = evals.reshape(d, fold, N // fold).transpose(0, 1) \
                if fold == 2 else FRI.leaf_rows(evals, 4).reshape(4, d, -1)
            assert torch.equal(K.fri_fold(src, xi, layer), exp[fold])
            for out_fold in (2, 4):
                got = K.fri_fold(src, xi, layer, out_fold=out_fold)
                assert got.shape == (out_fold * d, N // fold // out_fold)
                assert torch.equal(got, _leaf_rows(exp[fold], out_fold))


def test_rows_refused_where_they_do_not_divide():
    layer = K.FoldLayer(F.GENERATOR, JPH.root_of_unity(32), 32, 4, "cpu")
    groups = torch.zeros((4, 1, 6), dtype=torch.int64)
    with pytest.raises(ValueError):
        K.fri_fold(groups, [1], layer, out_fold=4)
    with pytest.raises(ValueError):
        K.fri_fold(groups, [1, 2], layer)


# ---- the kernel's formula in Python ints ----------------------------------
def _mm(a, b):
    """f63_mmul: REDC(a b) of Montgomery patterns."""
    return a * b * R_INV % P


def _kernel_matrix(a, d):
    """csrc/deep.cu ext_matrix of a (d Montgomery patterns, as the
    wrapper passes xi and xi^2): row-major, additions and triples only."""
    if d == 1:
        return [[a[0]]]
    if d == 2:
        return [[a[0], 3 * a[1] % P], [a[1], a[0]]]
    b1 = (a[0] + 3 * a[2]) % P
    return [[a[0], a[2], a[1]], [a[1], b1, (a[2] + 3 * a[1]) % P],
            [a[2], a[1], b1]]


def _matrix(a, d):
    """The multiplication matrix of a (d standard-form ints), column i a
    x^i by the JAX package's host_ext_mul, Montgomery."""
    cols = [JXF.host_ext_mul(a, [int(i == k) for k in range(d)], d)
            for i in range(d)]
    return [[_mont(cols[i][e]) for i in range(d)] for e in range(d)]


def _mat_mul(t, m, d):
    """csrc/deep.cu ext_mul_mat: coordinate e one sum of d products
    t_i m[e][i], reduced once."""
    return [sum(t[i] * m[e][i] for i in range(d)) * R_INV % P
            for e in range(d)]


def _kernel_point(v, ix, m1, m2, step_inv, scale, d, fold):
    """csrc/deep.cu fold_point, operation for operation: v[t][e]
    Montgomery patterns of the fold values, ix = 1/x, the matrices of xi
    and xi^2, w^-step and 1/fold (Montgomery)."""
    t = _mat_mul([_mm((v[0][e] - v[fold // 2][e]) % P, ix)
                  for e in range(d)], m1, d)
    if fold == 2:
        return [_mm((v[0][e] + v[1][e] + t[e]) % P, scale) for e in range(d)]
    a = [(v[0][e] + v[2][e] + t[e]) % P for e in range(d)]
    ix1 = _mm(ix, step_inv)
    t = _mat_mul([_mm((v[1][e] - v[3][e]) % P, ix1) for e in range(d)],
                 m1, d)
    b = [(v[1][e] + v[3][e] + t[e]) % P for e in range(d)]
    ix2 = _mm(ix, ix)
    t = _mat_mul([_mm((a[e] - b[e]) % P, ix2) for e in range(d)], m2, d)
    return [_mm((a[e] + b[e] + t[e]) % P, scale) for e in range(d)]


def _scalars(xi, d):
    """The wrapper's xi and xi^2 as the kernel reads them: d Montgomery
    words each (ops/kernels.py _fold_scalars)."""
    words = [np.frombuffer(b, dtype="<u8").tolist()
             for b in K._fold_scalars(xi, d)]
    assert all(w[d:] == [0] * (3 - d) for w in words)
    return [w[:d] for w in words]


def test_kernel_formula_equals_fold4_host():
    """d = 1, fold 4: the model against fold4_host at random points, and
    with every value, xi and x at p - 1."""
    rng = np.random.default_rng(7)
    n = 1 << 10
    i_inv = pow(JPH.root_of_unity(n), P - 1 - n // 4, P)
    assert pow(i_inv, P - 2, P) == JPH.root_of_unity(4)
    cases = [[int(c) for c in rng.integers(1, P, size=6, dtype=np.uint64)]
             for _ in range(64)] + [[P - 1] * 6]
    for *vals, xi, x0 in cases:
        exp = JFRI.fold4_host(vals, xi, x0, n)
        x1, x2 = _scalars([xi], 1)
        got = _kernel_point([[_mont(v)] for v in vals],
                            _mont(pow(x0, P - 2, P)), _kernel_matrix(x1, 1),
                            _kernel_matrix(x2, 1), _mont(i_inv),
                            _mont(pow(4, P - 2, P)), 1, 4)
        assert got[0] * R_INV % P == exp


@pytest.mark.parametrize("d", [1, 2, 3])
def test_kernel_formula_equals_host_fold(d):
    """Fold 2 and 4: the model at every point of the layer against the
    host fold once / twice, on random values and on p - 1 everywhere
    (values and xi); the kernel's matrices of the wrapper's xi and xi^2
    equal their multiplication matrices."""
    o, gw = F.GENERATOR, JPH.root_of_unity(N)
    for vals, xi in _inputs(d):
        ev = vals.tolist()
        exp = _host_folds(F.to_ints(vals).tolist(), xi, d)
        x1, x2 = _scalars(xi, d)
        m1, m2 = _kernel_matrix(x1, d), _kernel_matrix(x2, d)
        assert m1 == _matrix(xi, d)
        assert m2 == _matrix(JXF.host_ext_mul(xi, xi, d), d)
        for fold in (2, 4):
            step = N // fold
            want = exp[fold].tolist()
            step_inv = _mont(pow(gw, P - 1 - step, P))
            scale = _mont(pow(fold, P - 2, P))
            for j in range(step):
                ix = _mont(pow(o * pow(gw, j, P) % P, P - 2, P))
                v = [[ev[e][j + t * step] for e in range(d)]
                     for t in range(fold)]
                got = _kernel_point(v, ix, m1, m2, step_inv, scale, d,
                                    fold)
                assert got == [want[e][j] for e in range(d)]


# ---- the prover's loop ----------------------------------------------------
def test_prover_copies_only_the_first_layer(monkeypatch):
    """Chain 16 at d = 3, fold 4, remainder 16 (FRI layers of 512, 128
    and 32 points, then 8 values): leaf_rows runs once, on the DEEP
    values; every later
    layer's rows are the previous fold's own output, equal to leaf_rows
    of that fold's values, and the remainder is the last fold's values."""
    opts = ProofOptions(num_queries=8, blowup=4, hash_fn="blake3",
                        extension_degree=3, fri_max_remainder=16)
    ex = RC.RescueChainExample(16, opts, device="cpu")
    prover = Prover(ex.air(), device="cpu")
    assert [layer.size for layer in prover.fri_plan] == [512, 128, 32]
    calls, folds, in_fold = [], [], []
    leaf_rows, fold = FRI.leaf_rows, FRI.fold

    def counted_rows(evals, folding):
        if not in_fold:        # the plain fold's own rows are not counted
            calls.append(tuple(evals.shape))
        return leaf_rows(evals, folding)

    def kept_fold(rows, xi, layer, out_fold=0):
        in_fold.append(1)
        out = fold(rows, xi, layer, out_fold)
        in_fold.pop()
        folds.append((xi, layer, out_fold, out))
        return out
    monkeypatch.setattr(FRI, "leaf_rows", counted_rows)
    monkeypatch.setattr(FRI, "fold", kept_fold)
    rng = np.random.default_rng(5)
    deep = _rand(rng, 3, prover.bn)
    coin = type("Coin", (), {
        "reseed": lambda self, root: None,
        "draw_ext": lambda self, d: [int(v) for v in
                                     rng.integers(0, P, size=d,
                                                  dtype=np.uint64)]})()
    layers, rem = prover._fri_layers(coin, deep, None)
    assert calls == [(3, prover.bn)]
    assert torch.equal(layers[0].group, leaf_rows(deep, 4))
    for i, (xi, layer, out_fold, out) in enumerate(folds):
        vals = K.fri_fold(layers[i].group.reshape(4, 3, -1), xi, layer)
        if i + 1 < len(layers):
            assert out_fold == 4 and out is layers[i + 1].group
            assert torch.equal(out, leaf_rows(vals, 4))
        else:
            assert out_fold == 0 and out is rem
            assert torch.equal(rem, vals)
    assert len(folds) == len(layers) == len(prover.fri_plan)
