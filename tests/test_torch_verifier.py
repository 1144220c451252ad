"""The port's verifier (engine/verifier.py) against the JAX package's, on the
CPU. It accepts the port's proof of the base-field golden
`rescue_chain16_blake3` (tests/vectors/transcripts.json), first held to the
golden's bytes; tests/test_torch_prover.py and
tests/test_torch_transaction.py hold it to the proofs of
`rescue_chain16_rescue` and `transaction_2tx_d3_blake3`, and
tests/test_torch_extension_proofs.py to the extension goldens. Every case of tests/test_tamper.py, applied to the port's proof of
`rescue_chain16_cubic_grind4`, is rejected by both verifiers, the port's
VerificationError carrying the JAX verifier's phase tag. Tolerance: exact
equality."""
import hashlib
import json
import os

import pytest
import torch

from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine import verifier as V
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops.field import P
from certificate_stark_tpu_torch.utils import curve as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors")
TAMPER_OPTS = dict(num_queries=8, blowup=4, hash_fn="blake3",
                   extension_degree=3, grinding_bits=4)


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


def _load(path, name):
    with open(os.path.join(VECTORS, path)) as f:
        return json.load(f)[name]


def _prove(ex, golden):
    raw = Prover(ex.air(), device="cpu").prove(ex.trace).to_bytes()
    assert hashlib.sha256(raw).hexdigest() == golden["proof_sha256"]
    return Proof.from_bytes(raw)


def test_accepts_base_golden():
    opts = ProofOptions(num_queries=14, blowup=4, hash_fn="blake3")
    ex = RC.RescueChainExample(16, opts, device="cpu")
    assert ex.verify(_prove(ex, _load("transcripts.json",
                                      "rescue_chain16_blake3")))


# ---------------------------------------------------------------------------
# tamper cases (tests/test_tamper.py), on a cubic proof
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cubic():
    """The port's proof of rescue_chain16_cubic_grind4, as bytes, and its
    public inputs."""
    ex = RC.RescueChainExample(16, ProofOptions(**TAMPER_OPTS), device="cpu")
    g = _load("transcripts.json", "rescue_chain16_cubic_grind4")
    return _prove(ex, g).to_bytes(), ex.pub_inputs()


def _flip(v):
    return (int(v) + 1) % P


def _flip_digest(d):
    return (int(d[0]) ^ 1,) + tuple(d[1:])


def _set(attr, fn):
    def mutate(p):
        setattr(p, attr, fn(getattr(p, attr)))
    return mutate


def _query(fn):
    def mutate(p):
        fn(p.queries[0])
    return mutate


def _trace_value(q):
    q.trace_row = [_flip(q.trace_row[0])] + list(q.trace_row[1:])


def _h_value(q):
    q.h_row = [_flip(q.h_row[0])] + list(q.h_row[1:])


def _path_node(q):
    q.trace_path = [_flip_digest(q.trace_path[0])] + list(q.trace_path[1:])


def _fri_value(q):
    vals, path = q.fri_openings[0]
    q.fri_openings[0] = ([_flip(vals[0])] + list(vals[1:]), path)


COIN = ("pow", "queries", "fri")     # a diverged transcript's first gates
# name -> (mutation of the proof, verify kwargs, tags the case allows); the
# options and public inputs are given as functions of the proof
TAMPER = {
    "trace_root": (_set("trace_root", _flip_digest), None, ("ood",)),
    "h_root": (_set("h_root", _flip_digest), None, ("ood",)),
    "ood_trace_frame": (
        _set("ood_trace_z", lambda v: [v[0], _flip(v[1])] + list(v[2:])),
        None, ("ood",)),
    # the range AIR of tests/test_tamper.py reads no column 0 at z, and the
    # transcript catches it; the rescue chain reads every column
    "ood_column_0": (
        _set("ood_trace_z", lambda v: [_flip(v[0])] + list(v[1:])),
        None, ("ood",) + COIN),
    "ood_h": (_set("ood_h", lambda v: [_flip(v[0])] + list(v[1:])), None,
              ("ood",)),
    "query_trace_value": (_query(_trace_value), None, ("merkle",)),
    "query_h_value": (_query(_h_value), None, ("merkle",)),
    "merkle_path_node": (_query(_path_node), None, ("merkle",)),
    "fri_root": (_set("fri_roots", lambda r: [_flip_digest(r[0])]
                      + list(r[1:])), None, COIN),
    "fri_opening_value": (_query(_fri_value), None, ("fri",)),
    "fri_remainder": (
        _set("fri_remainder", lambda v: [_flip(v[0])] + list(v[1:])),
        None, COIN),
    "pow_nonce": (_set("pow_nonce", lambda n: int(n) + 1), None, ("pow",)),
    "dropped_query": (_set("queries", lambda q: q[:-1]), None,
                      ("queries",)),
    "expected_options": (
        None, lambda p: {"expected_options": dict(TAMPER_OPTS,
                                                  num_queries=42)},
        ("options",)),
    "min_security": (
        None, lambda p: {"min_security": p.security_level(True) + 1},
        ("options",)),
    "wrong_pub_inputs": (
        None, lambda p: {"pub_inputs": "wrong"}, ("ood",) + COIN),
}


def _run(verify, air, proof, pub, kwargs, opts_class):
    """The phase tag of the VerificationError the verifier raises."""
    kwargs = dict(kwargs)
    if kwargs.pop("pub_inputs", None):
        pub = (pub[0], [_flip(pub[1][0])] + list(pub[1][1:]))
    if "expected_options" in kwargs:
        kwargs["expected_options"] = opts_class(**kwargs["expected_options"])
    try:
        verify(air, proof, pub, **kwargs)
    except (V.VerificationError, JV.VerificationError) as e:
        return str(e).split(":", 1)[0]
    return None


@pytest.mark.parametrize("case", list(TAMPER))
def test_tampered_proof_rejected_by_both(cubic, case):
    raw, pub = cubic
    mutate, kwargs_of, tags = TAMPER[case]
    proof, jproof = Proof.from_bytes(raw), JProof.from_bytes(raw)
    if mutate:
        mutate(proof)
        mutate(jproof)
    kwargs = kwargs_of(proof) if kwargs_of else {}
    tag = _run(V.verify, RC.RescueChainAir, proof, pub, kwargs, ProofOptions)
    jtag = _run(JV.verify, JRC.RescueChainAir, jproof, pub, kwargs, JOpts)
    assert jtag in tags, f"JAX verifier: {jtag}"
    assert tag == jtag


def test_min_security_at_the_level_accepts(cubic):
    raw, pub = cubic
    proof = Proof.from_bytes(raw)
    assert V.verify(RC.RescueChainAir, proof, pub,
                    min_security=proof.security_level(True))
