"""The standalone AIR programs of the port (range, merkle-init,
merkle-update, Schnorr) against the JAX package's, on the CPU: the AIR
tables (degrees, periodic columns and their LDE, assertions, public-input
elements), the transition constraints on seeded random 64-point frames
through the JAX package's numpy facade (`NP`), and the verifier's batched
periodic-column values against the JAX verifier's Python-int path at
d = 1, 2 and 3 (for the Schnorr, merkle-update and transaction AIRs). The
traces are in tests/test_torch_subair_traces.py. Tolerance: exact
equality.

The module runs on the fp2 curve instance (the library default, which the
goldens use) in both packages."""
import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.fieldops import NP
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.models import merkle_init as JMI
from certificate_stark_tpu.models import merkle_update as JMU
from certificate_stark_tpu.models import range as JRG
from certificate_stark_tpu.models import schnorr as JSC
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu.utils import native as JNAT
from certificate_stark_tpu_torch.engine import verifier as V
from certificate_stark_tpu_torch.engine.air import (PeriodicAssertion,
                                                    SequenceAssertion)
from certificate_stark_tpu_torch.engine.fieldops import BASE
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.models import merkle_init as MI
from certificate_stark_tpu_torch.models import merkle_update as MU
from certificate_stark_tpu_torch.models import range as RG
from certificate_stark_tpu_torch.models import schnorr as SC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

P = JF.P
OPTS = dict(num_queries=14, blowup=8, hash_fn="blake3")


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


@pytest.fixture(scope="module")
def signed():
    """Two signed messages of the Schnorr example (seed 5)."""
    ex = SC.SchnorrExample(2, ProofOptions(**OPTS), device="cpu")
    return ex.messages, ex.signatures


# ---- AIR tables and constraints -------------------------------------------
def _airs(name, signed):
    """(port AIR, JAX AIR, trace width, periodic column count)."""
    po, jo = ProofOptions(**OPTS), JOpts(**OPTS)
    if name == "range":
        return (RG.RangeAir(64, [123456789], po),
                JRG.RangeAir(64, [123456789], jo), 2, 0)
    if name == "merkle-init":
        rng = np.random.default_rng(8)
        pub = ([int(v) for v in rng.integers(0, P, 14, dtype=np.uint64)],
               [int(v) for v in rng.integers(0, P, 14, dtype=np.uint64)], 77)
        return (MI.MerkleInitAir(16, pub, po), JMI.MerkleInitAir(16, pub, jo),
                58, 28)
    if name == "merkle-update":
        pub = ([11] * 7, [12] * 7)
        return (MU.MerkleUpdateAir(1024, pub, po, depth=3),
                JMU.MerkleUpdateAir(1024, pub, jo, depth=3), 65, 33)
    pub = signed
    return (SC.SchnorrAir(1024, pub, po), JSC.SchnorrAir(1024, pub, jo),
            56, 55)


AIRS = ["range", "merkle-init", "merkle-update", "schnorr"]


def _assertion_key(a):
    if isinstance(a, SequenceAssertion):
        return ("seq", a.column, a.first_step, a.period, tuple(a.values))
    if isinstance(a, PeriodicAssertion):
        return ("per", a.column, a.first_step, a.period, a.value)
    return ("one", a.column, a.step, a.value)


def _jax_assertion_key(a):
    kind = type(a).__name__
    if kind == "SequenceAssertion":
        return ("seq", a.column, a.first_step, a.period,
                tuple(int(v) for v in a.values))
    if kind == "PeriodicAssertion":
        return ("per", a.column, a.first_step, a.period, int(a.value))
    return ("one", a.column, a.step, int(a.value))


@pytest.mark.parametrize("name", AIRS)
def test_air_tables_match_jax(signed, name):
    air, jair, _, _ = _airs(name, signed)
    assert [(d.mult, d.cycles) for d in air.transition_degrees()] == \
        [(d.mult, d.cycles) for d in jair.transition_degrees()]
    assert air.ce_blowup() == jair.ce_blowup()
    cols, jcols = air.periodic_columns(), jair.periodic_columns()
    if jcols is None:
        assert cols is None
    else:
        assert cols == [[int(v) for v in col] for col in jcols]
        got = air.periodic_lde(8, F.GENERATOR, "cpu")
        assert np.array_equal(to_jax_limbs(got),
                              np.asarray(jair.periodic_lde(8, JF.GENERATOR)))
    assert [_assertion_key(a) for a in air.assertions()] == \
        [_jax_assertion_key(a) for a in jair.assertions()]
    assert air.pub_inputs_elements() == jair.pub_inputs_elements()


def _rand(shape, seed):
    """Seeded random elements: (port tensor, JAX limbs)."""
    vals = np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)
    limbs = JF.from_int(vals)
    return from_jax_limbs(limbs), limbs


@pytest.mark.parametrize("name", AIRS)
def test_evaluate_transition_matches_jax(signed, name):
    air, jair, w, n_per = _airs(name, signed)
    cur, jcur = _rand((w, 64), 41)
    nxt, jnxt = _rand((w, 64), 42)
    per, jper = _rand((max(n_per, 1), 64), 43)
    if not n_per:
        per, jper = None, None
    got = air.evaluate_transition(BASE, cur, nxt, per)
    exp = jair.evaluate_transition(NP, jcur, jnxt, jper)
    assert got.shape == (len(air.transition_degrees()), 64)
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


# ---- the verifier's periodic values -------------------------------------
def _periodic_airs(name, signed):
    if name == "transaction":
        pub, opts = ([11] * 7, [12] * 7), dict(OPTS)
        return (TX.TransactionAir(2048, pub, ProofOptions(**opts), depth=3),
                JTX.TransactionAir(2048, pub, JOpts(**opts), depth=3))
    air, jair, _, _ = _airs(name, signed)
    return air, jair


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("name", ["schnorr", "merkle-update", "transaction"])
def test_batched_periodic_values_match_jax_python_path(signed, monkeypatch,
                                                       name, d):
    # the JAX verifier's Python-int path: its native-C shortcut (d = 1) off
    monkeypatch.setattr(JNAT, "available", lambda: False)
    air, jair = _periodic_airs(name, signed)
    z = tuple(int(v) for v in np.random.default_rng(50 + d).integers(
        0, P, d, dtype=np.uint64))
    got = V._periodic_values_at(air, z, V._Ext(d))
    mul, add, _, _, lift, powi = JV._ext(d)
    exp = JV._periodic_values_at_ext(jair, z, d, mul, add, lift, powi)
    assert got == [[int(v) for v in e] for e in exp]


# ---- signature verification ----------------------------------------------
def test_verify_signature_accepts_the_example_and_rejects_tampering(signed):
    for msg, sig in zip(*signed):
        assert CV.verify_signature(msg, sig)
    msg, (r_x, s) = signed[0][0], signed[1][0]
    assert not CV.verify_signature(msg, (r_x, s + 1))
    bad = list(msg)
    bad[13] = (bad[13] + 1) % P               # a message element, not the key
    assert not CV.verify_signature(bad, (r_x, s))


def test_affine_point_ops_match_jax():
    """on_curve, add (doubling and the point at infinity included) and mul
    against the JAX package's, and mul against the comb table's
    projective k*G."""
    from certificate_stark_tpu_torch.utils import curve_batch as CB
    from certificate_stark_tpu_torch.utils import field_ref as FR
    g = CV.generator()
    assert g == JCV.generator() and CV.on_curve(g) and JCV.on_curve(g)
    g2, g3 = CV.add(g, g), CV.mul(3, g)
    assert g2 == JCV.add(g, g) == CV.mul(2, g)
    assert g3 == JCV.mul(3, g) == CV.add(g2, g)
    neg = (g[0], FR.f6_neg(g[1]))
    assert CV.add(g, neg) is None and JCV.add(g, neg) is None
    assert CV.add(None, g) == g and CV.mul(0, g) is None
    assert not CV.on_curve((g[0], g[0]))
    k = 0x1D2C3B4A59687
    proj = CB.mul_gen_proj(k)
    zinv = FR.f6_inv(FR.f6_from_limbs(proj[12:18]))
    assert CV.mul(k, g) == (FR.f6_mul(FR.f6_from_limbs(proj[0:6]), zinv),
                            FR.f6_mul(FR.f6_from_limbs(proj[6:12]), zinv))


def test_verify_signature_matches_jax():
    """One valid and one tampered signature through both packages' checks,
    on the subfield instance (the JAX check, affine with an fp6 inversion a
    point addition, takes seconds a call there and far longer on fp2)."""
    import random
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    JCV.set_curve("subfield")
    CV.set_curve("subfield")
    try:
        rng = random.Random(11)
        skey = rng.randrange(1, CV.SCALAR_Q)
        msg = (CV.pkey_coords(skey) + [rng.randrange(P) for _ in range(14)]
               + [0, 0])
        r_x, s = CV.sign(msg, skey, rng)
        for sig in ((r_x, s), (r_x, (s + 1) % CV.SCALAR_Q)):
            assert CV.verify_signature(msg, sig) == \
                JCV.verify_signature(msg, sig)
        assert CV.verify_signature(msg, (r_x, s))
    finally:
        JCV.set_curve(prev[0])
        CV.set_curve(prev[1])
