"""The proof's tail of the port (ops/kernels.py `ood`, `deep`, `fri_fold`,
csrc/deep.cu) on the CPU, where each wrapper runs its plain version:
`ood_plain` and `deep_plain` against the JAX package's `Prover.phase_ood`
and `Prover.phase_deep` on seeded inputs (rescue chain 16, blowup 4, d = 1:
its cubic phase_ood compiles for minutes), `fri_fold_plain` against
engine/fri.py `fold2_ext` applied once (fold 2) and twice (fold 4) at d = 1,
in both output modes (tests/test_torch_fri_rows.py holds d = 2, 3),
the sharded prover's start exponent and first index block by block
against the whole, a zero DEEP denominator mapped to 0, and the wrappers
refusing a device that is neither the CPU nor a card. The extension
degrees are held against the JAX package by the goldens of
tests/test_torch_extension_proofs.py, whose proofs run through all three
wrappers. The kernels run only on the card, where chip_smoke.py holds
them bit for bit against these plain versions. Tolerance: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import fri as JFRI
from certificate_stark_tpu.engine import prover as JPR
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu_torch.engine import fri as FRI
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops import extfield as XF
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.utils import poly_host as PH
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

OPTS = dict(num_queries=8, blowup=4, hash_fn="blake3")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs a worker process per core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(rng, *shape):
    """Uniform field elements (Montgomery patterns) from a numpy seed."""
    return torch.from_numpy(rng.integers(0, F.P, size=shape, dtype=np.uint64)
                            .astype(np.int64))


def _jax(t):
    return jnp.asarray(to_jax_limbs(t))


def _port(a):
    return from_jax_limbs(np.asarray(a))


@pytest.fixture(scope="module")
def chain16():
    """The chain-16 statement at d = 1: the port's Prover (its domain
    points and OOD points) and one JAX Prover for the module."""
    ex = RC.RescueChainExample(16, ProofOptions(**OPTS), device="cpu")
    prover = Prover(ex.air(), device="cpu")
    jprover = JPR.Prover(JRC.RescueChainAir(16 * 8, ex.pub_inputs(),
                                            JOpts(**OPTS)))
    return prover, jprover


def _deep_inputs(prover, rng):
    d, w, k, bn = prover.d, prover.w, prover.k, prover.bn
    return dict(lde=_rand(rng, w, bn), h_lde=_rand(rng, d, k, bn),
                oods=(_rand(rng, d, w), _rand(rng, d, w), _rand(rng, d, k)),
                g=(_rand(rng, d, w), _rand(rng, d, w), _rand(rng, d, k)))


def test_ood_plain_equals_jax(chain16):
    prover, jprover = chain16
    rng = np.random.default_rng(1)
    d, w, k, n = prover.d, prover.w, prover.k, prover.n
    coef, h, z = _rand(rng, w, n), _rand(rng, d, k, n), _rand(rng, d)
    exp = [_port(a) for a in jprover.phase_ood(_jax(coef), _jax(h), _jax(z))]
    got = K.ood_plain(coef, h, prover.ood_points(z))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    # the prover's phase, through the wrapper
    for g, e in zip(prover.phase_ood(coef, h, z), exp):
        assert torch.equal(g, e)


def test_deep_plain_equals_jax(chain16):
    prover, jprover = chain16
    rng = np.random.default_rng(2)
    inp = _deep_inputs(prover, rng)
    z = _rand(rng, prover.d)
    exp = _port(jprover.phase_deep(
        _jax(inp["lde"]), _jax(inp["h_lde"]), *map(_jax, inp["oods"]),
        *map(_jax, inp["g"]), _jax(z)))
    got = K.deep_plain(inp["lde"], inp["h_lde"], prover.xs,
                       prover.ood_points(z), *inp["oods"], *inp["g"])
    assert torch.equal(got, exp)
    assert torch.equal(prover.phase_deep(inp["lde"], inp["h_lde"],
                                         *inp["oods"], *inp["g"], z), exp)


def test_deep_zero_denominator(chain16):
    """z a domain point (d = 1): x - z is 0 there, and x - z g at the point
    b further; both points are 0, as in the JAX package, and every other
    point is the JAX package's value."""
    prover, jprover = chain16
    rng = np.random.default_rng(3)
    inp = _deep_inputs(prover, rng)
    j = 37
    z = prover.xs[j:j + 1].clone()
    got = K.deep(inp["lde"], inp["h_lde"], prover.xs, prover.ood_points(z),
                 *inp["oods"], *inp["g"])
    assert int(got[0, j]) == 0 and int(got[0, j + prover.b]) == 0
    assert int(torch.count_nonzero(got)) == prover.bn - 2
    exp = _port(jprover.phase_deep(
        _jax(inp["lde"]), _jax(inp["h_lde"]), *map(_jax, inp["oods"]),
        *map(_jax, inp["g"]), _jax(z)))
    assert torch.equal(got, exp)


def test_fri_fold_plain_equals_fold2_ext():
    """Fold 2: one fold2_ext; fold 4: fold2_ext with xi, then with xi^2 on
    the squared domain (d = 1 here: the cubic golden below holds d = 3,
    whose JAX fold2_ext compiles for seconds a call), on random values and
    on p - 1 everywhere (values and xi). Both output modes: the values
    [d, L], and the next layer's leaf rows [f d, L / f] laid out as the
    JAX prover's commit_kernel lays them (rows of 4 .. 16 points, below a
    warp), folded from the strided values and from the layer's own leaf
    rows."""
    d = 1
    rng = np.random.default_rng(11)
    n, o = 64, F.GENERATOR
    gw = PH.root_of_unity(n)
    worst = F.from_ints([[F.P - 1] * n] * d, "cpu")
    for evals, xi in ((_rand(rng, d, n), _rand(rng, d)),
                      (worst, worst[:, 0].clone())):
        once = JFRI.fold2_ext(_jax(evals), _jax(xi), o, gw, d)
        xi2 = XF.ext_mul(xi[:, None], xi[:, None], d)[:, 0]
        twice = JFRI.fold2_ext(once, _jax(xi2), o * o % F.P, gw * gw % F.P,
                               d)
        coin = F.to_ints(xi).tolist()       # as the coin draws it
        for fold, exp in ((2, once), (4, twice)):
            groups = evals.reshape(d, fold, n // fold).transpose(0, 1)
            layer = K.FoldLayer(o, gw, n, fold, "cpu")
            got = K.fri_fold_plain(groups, coin, layer)
            assert torch.equal(got, _port(exp))
            # the wrapper takes the same route on the CPU
            assert torch.equal(K.fri_fold(groups, coin, layer), got)
            rows = FRI.leaf_rows(evals, fold).reshape(fold, d, n // fold)
            for src in (groups, rows):
                for f in (2, 4):
                    leaf = exp.reshape(4, d, f, n // fold // f) \
                        .transpose(0, 2, 1, 3).reshape(4, f * d, -1)
                    assert torch.equal(K.fri_fold(src, coin, layer,
                                                  out_fold=f), _port(leaf))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_blocks(D):
    """The sharded prover's arguments: ood from the start exponent r m
    over the r-th coefficient block, summed over the blocks, is the whole
    sum; fri_fold of rank r's leaf rows (the values at t size/fold + r L +
    j) from the first index r L with step size/fold is block r of the
    whole layer's fold. d = 3."""
    rng = np.random.default_rng(20 + D)
    d, w, k, n = 3, 5, 4, 64
    coef, h, pts = _rand(rng, w, n), _rand(rng, d, k, n), _rand(rng, d, 3)
    whole = K.ood_plain(coef, h, pts)
    m = n // D
    parts = [K.ood(coef[:, r * m:(r + 1) * m], h[..., r * m:(r + 1) * m],
                   pts, r * m) for r in range(D)]
    for i, exp in enumerate(whole):
        total = parts[0][i]
        for part in parts[1:]:
            total = F.add(total, part[i])
        assert torch.equal(total, exp)
    for fold in (2, 4):
        size, o = 256, 7
        gw = PH.root_of_unity(size)
        evals, xi = _rand(rng, d, size), F.to_ints(_rand(rng, d)).tolist()
        L = size // fold // D
        layer = K.FoldLayer(o, gw, size, fold, "cpu")
        full = K.fri_fold(evals.reshape(d, fold, size // fold)
                          .transpose(0, 1), xi, layer)
        for r in range(D):
            rows = evals.reshape(d, fold, D, L)[:, :, r].transpose(0, 1) \
                .contiguous()
            got = K.fri_fold(rows, xi, layer, j0=r * L)
            assert torch.equal(got, full[:, r * L:(r + 1) * L])


def test_wrappers_refuse_other_devices():
    """On a device that is neither the CPU nor a card the wrappers raise;
    nothing falls back to the plain version."""
    meta = torch.empty((2, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        K.ood(meta, torch.empty((1, 1, 8), dtype=torch.int64,
                                device="meta"),
              torch.empty((1, 3), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        K.deep(meta, *[torch.empty(1, dtype=torch.int64, device="meta")] * 8,
               torch.empty((1, 1), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        K.fri_fold(meta.reshape(2, 1, 8), torch.empty(
            1, dtype=torch.int64, device="meta"), 7, 3)
