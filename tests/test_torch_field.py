"""The port's f63 field (certificate_stark_tpu_torch/ops/field.py and the
plain version of the f63_mul kernel) against the JAX package's field, on the
CPU. Inputs are numpy-seeded and reach both packages through
utils/convert.py. Tolerance: exact equality (field arithmetic)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.ops import pallas_kernels as PK
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

P = JF.P
EDGE = [0, 1, P - 1, P - 2, 1 << 32, (1 << 63) % P]


def _limbs(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
    return JF.from_int(np.array(vals + EDGE, dtype=object))


@pytest.fixture(scope="module")
def ab():
    a_l, b_l = _limbs(11, 4096), _limbs(12, 4096)
    return a_l, b_l, from_jax_limbs(a_l), from_jax_limbs(b_l)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_matches_jax(ab, op):
    a_l, b_l, a, b = ab
    exp = np.asarray(getattr(JF, op)(jnp.asarray(a_l), jnp.asarray(b_l)))
    assert np.array_equal(to_jax_limbs(getattr(F, op)(a, b)), exp)


@pytest.mark.parametrize("op", ["neg", "square", "double", "inv"])
def test_unary_matches_jax(ab, op):
    a_l, _, a, _ = ab
    exp = np.asarray(getattr(JF, op)(jnp.asarray(a_l)))
    assert np.array_equal(to_jax_limbs(getattr(F, op)(a)), exp)


@pytest.mark.parametrize("e", [0, 1, 3, 7, 1 << 40, P - 2,
                               3146514939656186539])
def test_pow_const_matches_jax(ab, e):
    a_l, _, a, _ = ab
    exp = np.asarray(JF.pow_const(jnp.asarray(a_l[:, :512]), e))
    assert np.array_equal(to_jax_limbs(F.pow_const(a[:512], e)), exp)


@pytest.mark.parametrize("n", [1, 6, 4102])
def test_batch_inverse_matches_jax(ab, n):
    a_l, _, a, _ = ab
    a_l, a = a_l[:, -n:], a[-n:]          # the tail holds the edge values
    exp = np.asarray(JF.inv(jnp.asarray(a_l)))
    assert np.array_equal(to_jax_limbs(F.batch_inv(a)), exp)


def test_mul_matches_pallas_interpret():
    a_l, b_l = _limbs(2, 2042), _limbs(3, 2042)      # 2048 with the edges
    got = K.f63_mul(from_jax_limbs(a_l), from_jax_limbs(b_l))
    exp = np.asarray(PK.pallas_mul(jnp.asarray(a_l), jnp.asarray(b_l),
                                   interpret=True))
    assert np.array_equal(to_jax_limbs(got), exp)


def test_wrapper_on_cpu_runs_the_plain_version(ab):
    _, _, a, b = ab
    before = K.f63_mul.launches
    assert torch.equal(K.f63_mul(a, b), K.mul_plain(a, b))
    assert K.f63_mul.launches == before


def test_mul_sum_matches_jax(ab):
    a_l, b_l, a, b = ab
    a_l, b_l = a_l[:, :4096].reshape(4, 16, 256), b_l[:, :4096].reshape(4, 16, 256)
    exp = np.asarray(JF.mul_sum(jnp.asarray(a_l), jnp.asarray(b_l), axis=1))
    got = F.mul_sum(a[:4096].reshape(16, 256), b[:4096].reshape(16, 256), 0)
    assert np.array_equal(to_jax_limbs(got), exp)


def test_field_sum_of_many_terms():
    vals = [P - 1] * 5000 + EDGE
    got = F.sum(F.from_ints(vals, "cpu"), dim=0)
    assert int(F.to_ints(got.reshape(1))[0]) == sum(vals) % P


def test_montgomery_conversions_match_jax():
    std = np.array(EDGE, dtype=object)
    mont = F.from_ints(EDGE, "cpu")
    assert np.array_equal(to_jax_limbs(mont), JF.from_int(std))
    assert list(F.to_ints(mont)) == [v % P for v in EDGE]
    plain = torch.tensor([v % P for v in EDGE], dtype=torch.int64)
    assert torch.equal(F.to_mont(plain), mont)
    assert torch.equal(F.from_mont(mont), plain)
    assert np.array_equal(to_jax_limbs(plain), JF.from_int(std, mont=False))


def test_limb_round_trip(ab):
    a_l, _, a, _ = ab
    assert np.array_equal(to_jax_limbs(a), a_l)
    assert torch.equal(from_jax_limbs(to_jax_limbs(a)), a)
    assert a.dtype == torch.int64 and int(a.min()) >= 0


def test_constants_match_jax():
    assert (F.P, F.GENERATOR, F.R_MOD_P, F.NPRIME) == \
        (JF.P, JF.GENERATOR, JF.R_MOD_P, JF.NPRIME)
