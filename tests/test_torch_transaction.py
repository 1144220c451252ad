"""The composed state-transition slice of the port against the JAX package,
on the CPU: the fp6/EC ops (compute and enforce, on seeded random points,
every kind of curve constant), the witness, the plain version of the trace
kernel, the AIR (degrees, periodic columns, assertions, constraint
evaluation), the Rescue leaf hash of 94-element rows, and the whole
2-transaction BLAKE3 proof, which must equal the committed golden byte for
byte and pass the port's verifier. The JAX side runs through its numpy facade (`NP`) or its host code.
Tolerance: exact equality.

The module runs on the fp2 curve instance (the library default, which the
goldens use) in both packages."""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine.fieldops import NP
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.ops import ecc as JE
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu.utils import witness as JW
from certificate_stark_tpu_torch.engine.fieldops import BASE
from certificate_stark_tpu_torch.engine.hasher import RescueHasher
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.engine.verifier import VerificationError
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import ecc as E
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils import witness as W
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = JF.P
GOLDEN = "transaction_2tx_d3_blake3"


@pytest.fixture(scope="module", autouse=True)
def fp2_curve():
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    JCV.set_curve("fp2")
    CV.set_curve("fp2")
    yield
    JCV.set_curve(prev[0])
    CV.set_curve(prev[1])


def _golden():
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        return json.load(f)[GOLDEN]


@pytest.fixture(scope="module")
def ex2():
    """The golden's statement: 2 transactions, depth 3, seed 3, and its
    trace from the plain version of the trace kernel."""
    g = _golden()
    ex = TX.TransactionExample(g["num_transactions"],
                               ProofOptions(**g["options"]),
                               depth=g["depth"], seed=g["seed"], device="cpu")
    return ex, ex.trace


def _rand(shape, seed):
    """Seeded random elements: (port tensor, JAX limbs)."""
    vals = np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)
    limbs = JF.from_int(vals)
    return from_jax_limbs(limbs), limbs


def _b3_cases():
    rng = np.random.default_rng(99)
    full = [int(v) for v in rng.integers(0, P, size=6, dtype=np.uint64)]
    return {"subfield": [3 * v % P for v in CV._load("subfield")["b_limbs"]],
            "fp2": [3 * v % P for v in CV._load("fp2")["b_limbs"]],
            "full_fp6": full}


@pytest.mark.parametrize("b3_name", ["subfield", "fp2", "full_fp6"])
def test_ecc_ops_match_jax(b3_name):
    b3 = _b3_cases()[b3_name]
    jb3 = JF.from_int(np.array(b3, dtype=object))[:, :, None]
    jb3s = jb3[:, None]               # for stacked points [4, 2, 18, B]
    pts, jpts = _rand((2, 18, 16), 1)          # two stacked points
    aff, jaff = _rand((2, 12, 16), 2)
    pt2, jpt2 = _rand((2, 18, 16), 3)
    cur, jcur = _rand((2, 19, 16), 4)
    nxt, jnxt = _rand((2, 19, 16), 5)
    flag, jflag = _rand((1, 1, 16), 6)
    cases = [
        (E.compute_double(BASE, pts, b3), JE.compute_double(NP, jpts, jb3s)),
        (E.compute_add_mixed(BASE, pts, aff, b3),
         JE.compute_add_mixed(NP, jpts, jaff, jb3s)),
        (E.compute_add(BASE, pts, pt2, b3),
         JE.compute_add(NP, jpts, jpt2, jb3s)),
        (E.f6_mul(BASE, pts[..., :6, :], pt2[..., 6:12, :]),
         JE.f6_mul(NP, jpts[..., :6, :], jpt2[..., 6:12, :])),
        (E.f6_inv(BASE, pts[..., :6, :]), JE.f6_inv(NP, jpts[..., :6, :])),
        (E.enforce_point_doubling(BASE, cur, nxt, flag, b3),
         JE.enforce_point_doubling(NP, jcur, jnxt, jflag, jb3s)),
        (E.enforce_point_addition_mixed(BASE, cur, nxt, aff, flag, b3),
         JE.enforce_point_addition_mixed(NP, jcur, jnxt, jaff, jflag, jb3s)),
        (E.enforce_point_addition_reduce_x(BASE, cur[0, :18], nxt[0, :18],
                                           pt2[0], flag[0], b3),
         JE.enforce_point_addition_reduce_x(NP, jcur[:, 0, :18],
                                            jnxt[:, 0, :18], jpt2[:, 0],
                                            jflag[:, 0], jb3)),
    ]
    for got, exp in cases:
        assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


@pytest.mark.parametrize("n, depth, seed", [(2, 3, 3), (9, 15, 42)])
def test_witness_matches_jax(n, depth, seed):
    got = W.build_random(n, depth, seed, with_signatures=True)
    exp = JW.build_random(n, depth, seed, with_signatures=True)
    for f in dataclasses.fields(exp):
        assert getattr(got, f.name) == getattr(exp, f.name), f.name
    for i in range(n):
        args = (got.s_old_values[i][:12], got.r_old_values[i][:12],
                got.deltas[i], got.s_old_values[i][13])
        assert W.build_tx_message(*args) == JW.build_tx_message(*args)


def test_plain_trace_matches_jax_tx_rows(ex2):
    ex, trace = ex2
    rows = []
    for t, msg, sig in zip(ex.md.tx_dicts(), ex.messages, ex.md.signatures):
        rows.extend(JTX.tx_rows(t, ex.depth, msg, sig))
    exp = JF.from_int(np.array(rows, dtype=object).T)
    assert np.array_equal(to_jax_limbs(trace), exp)
    # and the port's own host rows
    t, msg, sig = ex.md.tx_dicts()[1], ex.messages[1], ex.md.signatures[1]
    assert np.array_equal(
        F.to_ints(trace[:, 1024:]).T.tolist(),
        TX.tx_rows(t, ex.depth, msg, sig))
    g = _golden()
    assert hashlib.sha256(trace.numpy().astype("<i8").tobytes()) \
        .hexdigest() == g["trace_sha256"]


def _airs(n=2048, depth=3):
    pub = ([11] * 7, [12] * 7)
    opts = dict(num_queries=14, blowup=8, hash_fn="blake3")
    return (TX.TransactionAir(n, pub, ProofOptions(**opts), depth=depth),
            JTX.TransactionAir(n, pub, JOpts(**opts), depth=depth))


def test_air_tables_match_jax():
    air, jair = _airs()
    assert [(d.mult, d.cycles) for d in air.transition_degrees()] == \
        [(d.mult, d.cycles) for d in jair.transition_degrees()]
    assert air.periodic_columns() == \
        [[int(v) for v in col] for col in jair.periodic_columns()]
    got = air.periodic_lde(8, F.GENERATOR, "cpu")
    assert np.array_equal(to_jax_limbs(got),
                          jair.periodic_lde(8, JF.GENERATOR))
    assert [(a.column, a.step, a.value) for a in air.assertions()] == \
        [(a.column, a.step, a.value) for a in jair.assertions()]
    assert air.pub_inputs_elements() == jair.pub_inputs_elements()


def test_evaluate_transition_matches_jax():
    air, jair = _airs()
    cur, jcur = _rand((94, 64), 21)
    nxt, jnxt = _rand((94, 64), 22)
    per, jper = _rand((48, 64), 23)
    got = air.evaluate_transition(BASE, cur, nxt, per)
    exp = jair.evaluate_transition(NP, jcur, jnxt, jper)
    assert got.shape == (TX.N_CONSTRAINTS, 64)
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


def test_rescue_leaf_hash_of_transaction_rows_matches_jax():
    cols, _ = _rand((94, 3), 31)
    got = RescueHasher().to_host(RescueHasher().hash_columns(cols))
    std = F.to_ints(cols)
    jh = JH.RescueHasher()
    assert got == [jh.host_digest(list(std[:, j])) for j in range(3)]


@pytest.fixture(scope="module")
def blake3_proof(ex2):
    """The port's proof of the golden's statement: (coin journal, bytes)."""
    ex, trace = ex2
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    raw = prover.prove(trace).to_bytes()
    return prover.coin_journal, raw


def test_blake3_proof_equals_golden(ex2, blake3_proof):
    ex, _ = ex2
    g = _golden()
    assert [list(r) for r in ex.pub_inputs()] == [g["initial_root"],
                                                  g["final_root"]]
    journal, raw = blake3_proof
    assert [[k, v] for k, v in journal] == g["journal"]
    assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
    assert len(raw) == g["proof_len"] == 69524


def test_blake3_proof_passes_port_verifier(ex2, blake3_proof):
    """The port's own verifier accepts the golden proof, and rejects it
    with one OOD value of the next-row frame flipped."""
    ex, _ = ex2
    raw = blake3_proof[1]
    assert ex.verify(Proof.from_bytes(raw))
    bad = Proof.from_bytes(raw)
    bad.ood_trace_zg[3] = (bad.ood_trace_zg[3] + 1) % P
    with pytest.raises(VerificationError, match="^ood:"):
        ex.verify(bad)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opts = ProofOptions(num_queries=14, blowup=8, hash_fn="blake3")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TX.TransactionExample(1, opts, depth=3)
