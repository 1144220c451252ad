"""The port's NTT and LDE (certificate_stark_tpu_torch/ops/ntt.py) against
the JAX package on the CPU, 3 columns at 2^4..2^10, and the LDE from
coefficients at 1 and 2 points with blowups up to 2^8 and a shifted
offset; the inverse with a fused coset scale (`intt(a, scale_by)`)
against the JAX package's coset_scale(intt(x), o_inv), and a small
prover's `_split_composition` against the route it replaced (intt, then
coset_scale). Tolerance: exact equality.

Every size is held against the JAX package's host transform
(utils/poly_host.py, Python ints); the device transform ops/ntt.py, whose
XLA:CPU compiles cost seconds per shape, is held at the end sizes."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.ops import ntt as JN
from certificate_stark_tpu.utils import poly_host as JPH
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import ntt as N
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

P = JF.P
LOGS = list(range(4, 11))
OFFSET = JF.GENERATOR


def _ints(logn):
    rng = np.random.default_rng(logn)
    return [[int(v) for v in row] for row in
            rng.integers(0, P, size=(3, 1 << logn), dtype=np.uint64)]


def _host_lde(col, blowup):
    coeffs = JPH.intt(col)
    scaled = [c * pow(OFFSET, i, P) % P for i, c in enumerate(coeffs)]
    return JPH.ntt(scaled + [0] * ((blowup - 1) * len(col)))


@pytest.mark.parametrize("logn", LOGS)
def test_ntt_intt_match_jax_host_transform(logn):
    cols = _ints(logn)
    a = F.from_ints(cols, "cpu")
    assert [list(r) for r in F.to_ints(N.ntt(a))] == \
        [JPH.ntt(c) for c in cols]
    assert [list(r) for r in F.to_ints(N.intt(a))] == \
        [JPH.intt(c) for c in cols]


@pytest.mark.parametrize("blowup", [4, 8])
@pytest.mark.parametrize("logn", LOGS)
def test_lde_matches_jax_host_transform(logn, blowup):
    cols = _ints(logn)
    got = F.to_ints(N.lde(F.from_ints(cols, "cpu"), blowup, OFFSET))
    assert [list(r) for r in got] == [_host_lde(c, blowup) for c in cols]


def _host_lde_from_coeffs(coeffs, blowup, offset):
    scaled = [c * pow(offset, i, P) % P for i, c in enumerate(coeffs)]
    return JPH.ntt(scaled + [0] * ((blowup - 1) * len(coeffs)))


@pytest.mark.parametrize("logn,blowup", [(0, 1), (0, 2), (0, 256), (1, 1),
                                         (1, 2), (1, 256), (4, 256)])
def test_lde_from_coeffs_blowups_and_shifted_offset(logn, blowup):
    """The sequence assertions' LDE (engine/boundary.py `_sequence_evals`:
    blowup bn / m, the offset times g^-first) and the periodic columns'
    (n = 1 and 2 points, blowups far above 8)."""
    cols = _ints(logn)
    g_first = pow(JPH.root_of_unity(1 << 6), 5, P)
    shift = OFFSET * pow(g_first, P - 2, P) % P
    for offset in (OFFSET, shift):
        got = F.to_ints(N.lde_from_coeffs(F.from_ints(cols, "cpu"), blowup,
                                          offset))
        assert [list(r) for r in got] == \
            [_host_lde_from_coeffs(c, blowup, offset) for c in cols]


O_INV = pow(OFFSET, P - 2, P)


@functools.lru_cache(maxsize=None)
def _jax_device(logn):
    """The JAX package's jitted ntt, intt, coset_scale, lde and
    coset_scale(intt(x), 1/offset) of _ints(logn), in one compile."""
    a_l = JF.from_int(np.array(_ints(logn), dtype=object))

    @jax.jit
    def ref(x):
        return (JN.ntt(x), JN.intt(x), JN.coset_scale(x, OFFSET),
                JN.lde(x, 4, OFFSET), JN.coset_scale(JN.intt(x), O_INV))

    return from_jax_limbs(a_l), [np.asarray(r) for r in ref(jnp.asarray(a_l))]


@pytest.mark.parametrize("logn", [4, 10])
def test_transforms_match_jax_device_ntt(logn):
    a, exp = _jax_device(logn)
    got = [N.ntt(a), N.intt(a), N.coset_scale(a, OFFSET), N.lde(a, 4, OFFSET)]
    for g, e in zip(got, exp):
        assert np.array_equal(to_jax_limbs(g), e)


@pytest.mark.parametrize("logn", [4, 10])
def test_fused_inverse_matches_jax_coset_scale_of_intt(logn):
    """intt(x, scale_by=o_inv) == JAX coset_scale(intt(x), o_inv)
    (ops/ntt.py:315 over :311), the composition's split, for three
    columns; the same as the port's intt, then coset_scale; a scale on the
    forward transform refused."""
    a, exp = _jax_device(logn)
    got = N.intt(a, scale_by=O_INV)
    assert np.array_equal(to_jax_limbs(got), exp[4])
    assert torch.equal(got, N.coset_scale(N.intt(a), O_INV))
    with pytest.raises(ValueError):
        N.ntt(a, scale_by=O_INV)


@pytest.mark.parametrize("d", [1, 3])
def test_split_composition_matches_intt_then_coset_scale(d):
    """Prover._split_composition (the fused inverse) on random H values
    [d, bn] of a chain-16 prover equals the route it replaced: intt, then
    coset_scale by 1/offset, then the column split."""
    opts = ProofOptions(num_queries=8, blowup=4, hash_fn="blake3",
                        extension_degree=d)
    prover = Prover(RC.RescueChainExample(16, opts, device="cpu").air(),
                    device="cpu")
    comp = F.from_ints(_rand_rows(d, prover.bn, 40 + d), "cpu")
    o_inv = pow(prover.offset, P - 2, P)
    coeffs = N.coset_scale(N.intt(comp), o_inv)
    n, k = prover.n, prover.k
    exp = coeffs[:, :k * n].reshape(d, n, k).transpose(1, 2)
    assert torch.equal(prover._split_composition(comp), exp)


def _rand_rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in row] for row in
            rng.integers(0, P, size=(rows, n), dtype=np.uint64)]


def test_roots_of_unity_match_jax():
    for logn in range(0, 24):
        assert N.root_of_unity(1 << logn) == JN.root_of_unity(1 << logn)
