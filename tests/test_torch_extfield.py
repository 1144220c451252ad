"""The port's extension fields against the JAX package, on the CPU: the
device functions of ops/extfield.py (multiply, fused dot, inverse, powers,
embedding) at d = 2 and 3 on numpy-seeded inputs, their host mirrors, and
the HostExtOps facade that the verifier evaluates the AIRs through:
HostExtOps(1) against the device facade BASE on a random frame, and
HostExtOps(3) against the JAX package's HostExtOps(3) at one random
extension point, for the rescue-chain and the transaction AIRs.
Tolerance: exact equality.

The module runs on the fp2 curve instance (the goldens' one) in both
packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.engine.fieldops import HostExtOps as JHostExtOps
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.ops import extfield as JXF
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine.fieldops import BASE, HostExtOps
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import extfield as XF
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils.convert import to_jax_limbs

P = JF.P
DEGREES = (2, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def fp2_curve():
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    JCV.set_curve("fp2")
    CV.set_curve("fp2")
    yield
    JCV.set_curve(prev[0])
    CV.set_curve(prev[1])


def _rand(rng, shape):
    """Random field elements [*shape] (int64 CPU tensor)."""
    v = rng.integers(0, P, size=shape, dtype=np.uint64)
    return torch.from_numpy(v.view(np.int64).copy())


def _jax(t):
    return jnp.asarray(to_jax_limbs(t))


@pytest.mark.parametrize("d", DEGREES)
def test_ext_mul_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    a, b = _rand(rng, (d, 3, 40)), _rand(rng, (d, 3, 40))
    got = XF.ext_mul(a, b, d)
    assert np.array_equal(to_jax_limbs(got),
                          np.asarray(JXF.ext_mul(_jax(a), _jax(b), d)))
    # broadcasting a constant, as the FRI fold multiplies by xi
    c = _rand(rng, (d, 1, 1))
    assert torch.equal(XF.ext_mul(a, c, d),
                       XF.ext_mul(a, c.expand_as(a).contiguous(), d))


@pytest.mark.parametrize("d", DEGREES)
def test_ext_mul_sum_matches_jax(d):
    rng = np.random.default_rng(20 + d)
    a, b = _rand(rng, (d, 7, 33)), _rand(rng, (d, 7, 1))
    got = XF.ext_mul_sum(a, b, d, dim=1)
    exp = JXF.ext_mul_sum(_jax(a), _jax(b), d, axis=2)
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))
    got = XF.ext_mul_sum(a, a, d, dim=-1)
    exp = JXF.ext_mul_sum(_jax(a), _jax(a), d, axis=-1)
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


@pytest.mark.parametrize("d", DEGREES)
def test_ext_inv_vec_matches_jax(d):
    rng = np.random.default_rng(30 + d)
    a = _rand(rng, (d, 50))
    a[:, :2] = 0                   # 0 maps to 0
    a[1:, 2] = 0                   # a base-field element
    got = XF.ext_inv_vec(a, d)
    assert np.array_equal(to_jax_limbs(got),
                          np.asarray(JXF.ext_inv_vec(_jax(a), d)))
    one = XF.base_to_ext(F.const(1, "cpu").expand(47), d)
    assert torch.equal(XF.ext_mul(a[:, 3:], got[:, 3:], d), one)


@pytest.mark.parametrize("d", DEGREES)
def test_ext_powers_and_embedding_match_jax(d):
    rng = np.random.default_rng(40 + d)
    z = _rand(rng, (d,))
    got = XF.ext_powers_dyn(z, 37, d)
    assert np.array_equal(to_jax_limbs(got[:, :5]),
                          np.asarray(JXF.ext_powers_dyn(_jax(z), 5, d)))
    zi, acc = [int(v) for v in F.to_ints(z)], [1] + [0] * (d - 1)
    for j in range(37):                # the rest against host products
        assert [int(v) for v in F.to_ints(got[:, j])] == acc
        acc = JXF.host_ext_mul(acc, zi, d)
    zs = _rand(rng, (d, 3))            # three points at once
    assert torch.equal(XF.ext_powers_dyn(zs, 9, d)[:, 1],
                       XF.ext_powers_dyn(zs[:, 1], 9, d))
    a = _rand(rng, (5, 4))
    assert np.array_equal(to_jax_limbs(XF.base_to_ext(a, d)),
                          np.asarray(JXF.base_to_ext(_jax(a), d)))


@pytest.mark.parametrize("d", DEGREES)
def test_host_functions_match_jax_and_device(d):
    rng = np.random.default_rng(50 + d)
    a, b = _rand(rng, (d, 20)), _rand(rng, (d, 20))
    prod = F.to_ints(XF.ext_mul(a, b, d))
    inv = F.to_ints(XF.ext_inv_vec(a, d))
    ai, bi = F.to_ints(a), F.to_ints(b)
    for j in range(20):
        x, y = [int(v) for v in ai[:, j]], [int(v) for v in bi[:, j]]
        assert XF.host_ext_mul(x, y, d) == JXF.host_ext_mul(x, y, d) \
            == [int(v) for v in prod[:, j]]
        assert XF.host_ext_inv(x, d) == JXF.host_ext_inv(x, d) \
            == [int(v) for v in inv[:, j]]
    vals = [[int(v) for v in ai[:, j]] for j in range(20)]
    assert torch.equal(XF.from_ints(vals, d, "cpu"), a)
    assert XF.flat_ints(a) == [v for row in vals for v in row]


# ---------------------------------------------------------------------------
# HostExtOps: the verifier's facade
# ---------------------------------------------------------------------------
def _airs():
    opts = ProofOptions(num_queries=8, blowup=8, hash_fn="blake3")
    jopts = JOpts(num_queries=8, blowup=8, hash_fn="blake3")
    pub_c = (RC.SEED, [0] * 7)
    pub_t = ([1] * 7, [2] * 7)
    return {
        "rescue_chain": (RC.RescueChainAir(32, pub_c, opts),
                         JRC.RescueChainAir(32, pub_c, jopts)),
        "transaction": (TX.TransactionAir(1024, pub_t, opts, depth=3),
                        JTX.TransactionAir(1024, pub_t, jopts, depth=3)),
    }


def _host_frame(ints):
    """Object array [k, B] of d-tuples from ints [k, B, d]."""
    out = np.empty(ints.shape[:2], dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = tuple(int(v) % P for v in ints[idx])
    return out


@pytest.mark.parametrize("air_name", ["rescue_chain", "transaction"])
def test_host_ext_ops_1_matches_base(air_name):
    """The same constraint code through HostExtOps(1) on host ints and
    through BASE on tensors, at two random domain points."""
    air, _ = _airs()[air_name]
    rng = np.random.default_rng(60)
    npe = len(air.periodic_columns())
    frames = [_rand(rng, (k, 2)) for k in (air.trace_width,
                                           air.trace_width, npe)]
    got_base = air.evaluate_transition(BASE, *frames)
    fx = HostExtOps(1)
    host = [_host_frame(F.to_ints(t)[:, :, None]) for t in frames]
    got_host = air.evaluate_transition(fx, *host)
    assert got_host.shape == tuple(got_base.shape)
    exp = F.to_ints(got_base)
    for idx in np.ndindex(got_host.shape):
        assert got_host[idx] == (int(exp[idx]),)


@pytest.mark.parametrize("air_name", ["rescue_chain", "transaction"])
def test_host_ext_ops_3_matches_jax(air_name):
    """The port's AIR through HostExtOps(3) and the JAX package's through
    its HostExtOps(3), at one random cubic point."""
    air, jair = _airs()[air_name]
    rng = np.random.default_rng(70)
    npe = len(air.periodic_columns())
    ints = [rng.integers(0, P, size=(k, 3), dtype=np.uint64).tolist()
            for k in (air.trace_width, air.trace_width, npe)]
    fx = HostExtOps(3)
    got = air.evaluate_transition(fx, *(fx.from_coeffs(v) for v in ints))
    jfx = JHostExtOps(3)
    exp = jair.evaluate_transition(jfx, *(jfx.from_coeffs(v) for v in ints))
    assert got.shape[0] == exp.shape[1] == len(air.transition_degrees())
    assert [tuple(got[i, 0]) for i in range(got.shape[0])] == \
        [tuple(exp[0, i, 0]) for i in range(exp.shape[1])]
