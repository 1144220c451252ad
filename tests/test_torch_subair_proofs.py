"""Proofs of the port's standalone AIR programs against the JAX package, on
the CPU: the goldens `range_64bit` (tests/vectors/transcripts.json),
`range_64bit_rescue`, `merkle_init_rescue`, `merkle_update_1tx_d3_blake3`
and `schnorr_2sig_blake3` (tests/vectors/torch_goldens.json) are
reproduced byte for byte with their coin journals, both the JAX package's
verifier and the port's accept each proof, and both reject a wrong number,
a wrong root and a wrong message with the same phase tag. `get_example`
builds all six programs. Tolerance: exact equality.

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
from certificate_stark_tpu.models import merkle_init as JMI
from certificate_stark_tpu.models import merkle_update as JMU
from certificate_stark_tpu.models import range as JRG
from certificate_stark_tpu.models import schnorr as JSC
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine import verifier as V
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import get_example
from certificate_stark_tpu_torch.models import merkle_init as MI
from certificate_stark_tpu_torch.models import merkle_update as MU
from certificate_stark_tpu_torch.models import range as RG
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.models import schnorr as SC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops.field import P
from certificate_stark_tpu_torch.utils import curve as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors")
# name -> (vector file, options where the file does not hold them)
GOLDENS = {
    "range_64bit": ("transcripts.json",
                    dict(num_queries=14, blowup=8, hash_fn="blake3")),
    "range_64bit_rescue": ("torch_goldens.json", None),
    "merkle_init_rescue": ("torch_goldens.json", None),
    "merkle_update_1tx_d3_blake3": ("torch_goldens.json", None),
    "schnorr_2sig_blake3": ("torch_goldens.json", None),
}
# the JAX AIR of each program, and the port's
AIRS = {"range": (JRG.RangeAir, RG.RangeAir),
        "merkle_init": (JMI.MerkleInitAir, MI.MerkleInitAir),
        "merkle_update": (JMU.MerkleUpdateAir, MU.MerkleUpdateAir),
        "schnorr": (JSC.SchnorrAir, SC.SchnorrAir)}


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


def _program(name):
    return next(k for k in AIRS if name.startswith(k))


def _example(name):
    """The port's example of one golden's statement, and its air kwargs."""
    g, opts = _golden(name)
    if name == "range_64bit":
        return RG.RangeExample(0x0123456789ABCDEF, opts, device="cpu"), {}
    if name.startswith("range"):
        return RG.RangeExample(g["number"], opts, device="cpu"), {}
    if name.startswith("merkle_init"):
        return MI.MerkleInitExample(opts, device="cpu"), {}
    if name.startswith("merkle_update"):
        return MU.MerkleUpdateExample(g["num_transactions"], opts,
                                      depth=g["depth"], seed=g["seed"],
                                      device="cpu"), {"depth": g["depth"]}
    return SC.SchnorrExample(g["num_signatures"], opts, seed=g["seed"],
                             device="cpu"), {}


@pytest.fixture(scope="module", params=list(GOLDENS))
def proven(request):
    """(name, example, air kwargs, coin journal, proof bytes) of the port's
    proof of one golden's statement."""
    name = request.param
    ex, kwargs = _example(name)
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    raw = prover.prove(ex.trace).to_bytes()
    return name, ex, kwargs, prover.coin_journal, raw


def test_golden_reproduced(proven):
    name, ex, _, journal, raw = proven
    g, _ = _golden(name)
    if "initial_root" in g:
        assert [list(r) for r in ex.pub_inputs()] == [g["initial_root"],
                                                      g["final_root"]]
    if "s_values" in g:
        assert [str(s) for _, s in ex.signatures] == g["s_values"]
    assert [[kind, val] for kind, val in journal] == g["journal"]
    assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
    assert len(raw) == g["proof_len"]


def test_jax_verifier_accepts(proven):
    name, ex, kwargs, _, raw = proven
    _, opts = _golden(name)
    assert JV.verify(AIRS[_program(name)][0], JProof.from_bytes(raw),
                     ex.pub_inputs(), air_kwargs=kwargs,
                     expected_options=JOpts(**opts.__dict__))


def test_port_verifier_accepts(proven):
    _, ex, _, _, raw = proven
    assert ex.verify(Proof.from_bytes(raw))


def _wrong_inputs(name, ex):
    """A wrong public input of each program: the number negated (the JAX
    package's tests/test_range.py), a final-root element changed, a
    message element changed."""
    if name.startswith("range"):
        return [(-ex.number) % P]
    if name.startswith("merkle_init"):
        # the reference's negative pattern (tests/test_merkle_init.py)
        return (ex.r_inputs, ex.r_inputs, 2 * ex.delta)
    if name.startswith("merkle_update"):
        initial, final = ex.pub_inputs()
        return (initial, [(final[0] + 1) % P] + final[1:])
    messages = [list(m) for m in ex.messages]
    messages[0][13] = (messages[0][13] + 1) % P
    return (messages, ex.signatures)


def _tag(verify, air, proof, pub, kwargs):
    try:
        verify(air, proof, pub, air_kwargs=kwargs)
    except (V.VerificationError, JV.VerificationError) as e:
        return str(e).split(":", 1)[0]
    return None


def test_wrong_public_input_rejected_by_both(proven):
    name, ex, kwargs, _, raw = proven
    jair, air = AIRS[_program(name)]
    pub = _wrong_inputs(name, ex)
    jtag = _tag(JV.verify, jair, JProof.from_bytes(raw), pub, kwargs)
    assert jtag is not None
    assert _tag(V.verify, air, Proof.from_bytes(raw), pub, kwargs) == jtag


def test_get_example_builds_every_program():
    opts = ProofOptions(num_queries=8, blowup=8, hash_fn="blake3")
    cases = {"rescue-chain": (RC.RescueChainExample, dict(size=2), 16),
             "range": (RG.RangeExample, dict(size=5), 64),
             "merkle-init": (MI.MerkleInitExample, {}, 16),
             "merkle-update": (MU.MerkleUpdateExample,
                               dict(size=1, depth=3), 512),
             "schnorr": (SC.SchnorrExample, dict(size=1), 512),
             "transaction": (TX.TransactionExample, dict(size=1, depth=3),
                             1024)}
    for name, (cls, kw, n) in cases.items():
        ex = get_example(name, options=opts, device="cpu", **kw)
        assert type(ex) is cls and ex.options == opts
        assert ex.air().trace_length == n
    ex = get_example("range", 7, device="cpu")
    assert ex.options == ProofOptions(hash_fn="blake3")
    assert tuple(ex.trace.shape) == (2, 64)
    with pytest.raises(ValueError, match="unknown example"):
        get_example("fibonacci", device="cpu")


def test_sub_air_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opts = ProofOptions(num_queries=8, blowup=8, hash_fn="blake3")
    for make in (lambda: RG.RangeExample(5, opts),
                 lambda: MI.MerkleInitExample(opts),
                 lambda: MU.MerkleUpdateExample(1, opts, depth=3),
                 lambda: SC.SchnorrExample(1, opts),
                 lambda: get_example("range", 5),
                 lambda: RG.build_trace(5)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
