"""Extension-field proofs of the port against the JAX package, on the CPU:
the goldens `rescue_chain16_cubic_grind4` (tests/vectors/transcripts.json),
`rescue_chain16_quadratic_rescue_grind11` and
`transaction_2tx_d3_cubic_blake3` (tests/vectors/torch_goldens.json) are
reproduced byte for byte with their coin journals, each through the
proof's tail wrappers (ops/kernels.py `ood`, `deep`, `fri_fold`, whose
plain versions are counted), and both the JAX package's verifier and the
port's accept each proof, and a fold-by-2 quadratic proof that no golden
pins. Tolerance: exact equality.

The module runs on the fp2 curve instance (the goldens' one) in both
packages."""
import hashlib
import json
import os

import pytest
import torch

from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine import verifier as V
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops.field import P
from certificate_stark_tpu_torch.utils import curve as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors")
# name -> (vector file, options where the file does not hold them)
GOLDENS = {
    "rescue_chain16_cubic_grind4": (
        "transcripts.json", dict(num_queries=8, blowup=4, hash_fn="blake3",
                                 extension_degree=3, grinding_bits=4)),
    "rescue_chain16_quadratic_rescue_grind11": ("torch_goldens.json", None),
    "transaction_2tx_d3_cubic_blake3": ("torch_goldens.json", None),
}


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


def _golden(name):
    path, opts = GOLDENS[name]
    with open(os.path.join(VECTORS, path)) as f:
        g = json.load(f)[name]
    return g, ProofOptions(**(opts or g["options"]))


def _counting_tail():
    """The tail wrappers' plain versions wrapped to count their calls ->
    (counts, restore)."""
    counts = {"ood_plain": 0, "deep_plain": 0, "fri_fold_plain": 0}
    saved = {name: getattr(K, name) for name in counts}

    def counted(name):
        def fn(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return fn
    for name in counts:
        setattr(K, name, counted(name))

    def restore():
        for name, fn in saved.items():
            setattr(K, name, fn)
    return counts, restore


@pytest.fixture(scope="module", params=sorted(GOLDENS))
def proven(request):
    """(name, example, JAX air class and kwargs, coin journal, bytes, the
    tail's plain calls with the proof's FRI layers and domain segments) of
    the port's proof of one golden's statement."""
    name = request.param
    g, opts = _golden(name)
    if name.startswith("transaction"):
        ex = TX.TransactionExample(g["num_transactions"], opts,
                                   depth=g["depth"], seed=g["seed"],
                                   device="cpu")
        jair = (JTX.TransactionAir, {"depth": g["depth"]})
    else:
        ex = RC.RescueChainExample(16, opts, device="cpu")
        jair = (JRC.RescueChainAir, {})
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    counts, restore = _counting_tail()
    try:
        proof = prover.prove(ex.trace)
    finally:
        restore()
    tail = (counts, len(proof.fri_roots), len(prover._segments()))
    return name, ex, jair, prover.coin_journal, proof.to_bytes(), tail


def test_golden_reproduced(proven):
    name, ex, _, journal, raw, _ = proven
    g, _ = _golden(name)
    if "initial_root" in g:
        assert [list(r) for r in ex.pub_inputs()] == [g["initial_root"],
                                                      g["final_root"]]
    assert [[kind, val] for kind, val in journal] == g["journal"]
    assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
    assert len(raw) == g["proof_len"]


def test_jax_verifier_accepts(proven):
    name, ex, (air_class, kwargs), _, raw, _ = proven
    _, opts = _golden(name)
    assert JV.verify(air_class, JProof.from_bytes(raw), ex.pub_inputs(),
                     air_kwargs=kwargs,
                     expected_options=JOpts(**opts.__dict__))


def test_port_verifier_accepts(proven):
    _, ex, _, _, raw, _ = proven
    assert ex.verify(Proof.from_bytes(raw))


def test_tail_through_the_wrappers(proven):
    """The golden's proof ran its tail through the three wrappers: one
    ood, a deep a domain segment and a fri_fold a FRI layer, each on the
    CPU through its plain version (test_golden_reproduced holds the
    bytes)."""
    counts, layers, segments = proven[-1]
    assert layers > 0 and segments > 0
    assert counts == {"ood_plain": 1, "deep_plain": segments,
                      "fri_fold_plain": layers}


def test_fold2_quadratic_proof_passes_both_verifiers():
    opts = ProofOptions(num_queries=8, blowup=4, hash_fn="blake3",
                        extension_degree=2, fri_folding=2)
    ex = RC.RescueChainExample(16, opts, device="cpu")
    raw = Prover(ex.air(), device="cpu").prove(ex.trace).to_bytes()
    assert ex.verify(Proof.from_bytes(raw))
    assert JV.verify(JRC.RescueChainAir, JProof.from_bytes(raw),
                     ex.pub_inputs())
    proof = Proof.from_bytes(raw)
    vals, path = proof.queries[0].fri_openings[0]
    proof.queries[0].fri_openings[0] = ([(vals[0] + 1) % P] + vals[1:],
                                        path)
    with pytest.raises(V.VerificationError, match="^fri:"):
        ex.verify(proof)
