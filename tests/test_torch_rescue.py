"""The port's Rescue63 (certificate_stark_tpu_torch/ops/rescue.py, the plain
version of the rescue_permutation kernel, the host Rescue) against the JAX
package, on the CPU. Tolerance: exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.ops import rescue as JR
from certificate_stark_tpu.utils import rescue_ref as JRR
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops import rescue as R
from certificate_stark_tpu_torch.utils import rescue_ref as RR
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

P = JF.P


def _limbs(seed, shape):
    rng = np.random.default_rng(seed)
    return JF.from_int(rng.integers(0, P, size=shape, dtype=np.uint64))


@pytest.mark.parametrize("n", [8, 256])
def test_permutation_matches_jax(n):
    """Against ops/rescue.permutation, the plain reference of the Pallas
    kernel (tests/test_pallas.py holds the two equal in interpret mode;
    interpret mode itself takes minutes per shape on XLA:CPU)."""
    st = _limbs(n, (14, n))
    got = to_jax_limbs(R.permutation(from_jax_limbs(st)))
    assert np.array_equal(got, np.asarray(JR.permutation(jnp.asarray(st))))


def test_permutation_matches_jax_host_reference():
    st = _limbs(9, (14, 4))
    got = F.to_ints(R.permutation(from_jax_limbs(st)))
    ints = JF.to_int(st)
    for j in range(4):
        assert list(got[:, j]) == JRR.permutation([int(v) for v in ints[:, j]])


def test_wrapper_on_cpu_runs_the_plain_version():
    st = from_jax_limbs(_limbs(5, (14, 16)))
    mds, _, ark = R.tables("cpu")
    before = K.rescue_permutation.launches
    assert torch.equal(K.rescue_permutation(st, mds, ark),
                       K.rescue_permutation_plain(st, mds, ark))
    assert K.rescue_permutation.launches == before


@pytest.mark.parametrize("k", [7, 14, 16])
def test_digest_matches_jax(k):
    """k=16 against ops/rescue.digest (two full chunks and a partial one);
    every k against the JAX package's Python-int sponge."""
    el = _limbs(100 + k, (k, 8))
    got = R.digest(from_jax_limbs(el))
    if k == 16:
        exp = np.asarray(JR.digest(jnp.asarray(el)))
        assert np.array_equal(to_jax_limbs(got), exp)
    ints, got_i = JF.to_int(el), F.to_ints(got)
    for j in range(8):
        assert list(got_i[:, j]) == JRR.digest([int(v) for v in ints[:, j]])


def test_merge4_matches_jax():
    d0, d1 = _limbs(21, (4, 8)), _limbs(22, (4, 8))
    exp = np.asarray(JR.merge4(jnp.asarray(d0), jnp.asarray(d1)))
    got = R.merge4(from_jax_limbs(d0), from_jax_limbs(d1))
    assert np.array_equal(to_jax_limbs(got), exp)


@pytest.mark.parametrize("fn", ["sbox", "inv_sbox", "mds", "inv_mds",
                                "round"])
def test_round_parts_match_jax(fn):
    st = _limbs(31, (14, 8))
    s = from_jax_limbs(st)
    js = jnp.asarray(st)
    got, exp = {
        "sbox": lambda: (R.sbox(s), JR.sbox(js)),
        "inv_sbox": lambda: (R.inv_sbox(s), JR.inv_sbox(js)),
        "mds": lambda: (R.mds_apply(s), JR.mds_apply(js)),
        "inv_mds": lambda: (R.mds_apply(s, inverse=True),
                            JR.mds_apply(js, JR.INV_MDS)),
        "round": lambda: (R.apply_round(s, 5), JR.apply_round(js, 5)),
    }[fn]()
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


def test_constant_tables_match_jax():
    for mine, theirs in ((R.MDS, JR.MDS), (R.INV_MDS, JR.INV_MDS),
                         (R.ARK, JR.ARK)):
        assert np.array_equal(to_jax_limbs(torch.from_numpy(mine)), theirs)


def test_host_rescue_matches_jax_reference():
    rng = np.random.default_rng(41)
    state = [int(v) for v in rng.integers(0, P, size=14, dtype=np.uint64)]
    assert RR.permutation(state) == JRR.permutation(state)
    for k in (1, 7, 9, 14):
        assert RR.digest(state[:k]) == JRR.digest(state[:k])
    assert RR.merge4(state[:4], state[4:8]) == JRR.merge4(state[:4],
                                                          state[4:8])
