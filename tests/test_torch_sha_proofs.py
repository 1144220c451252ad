"""SHA-256 and SHA3-256 proofs of the port against the JAX package, on the
CPU: the goldens `rescue_chain16_sha256`, `rescue_chain16_sha3`,
`rescue_chain16_sha256_grind12` and `transaction_2tx_d3_sha256`
(tests/vectors/torch_goldens.json) are reproduced byte for byte with their
coin journals (and the transaction's trace roots), the JAX package's
verifier and the port's accept each proof and reject it with one opened
value flipped; and grinding at 11 and 12 bits with either hasher (the
batched search, one merge of the hasher a batch) returns the nonce of the
JAX coin's `_grind_device` and of the host loop.
`transaction_2tx_d3_sha3` is in tests/test_torch_sha3_tx_proof.py, with
the helpers of this module (a two-transaction proof takes some 25 s on one
CPU thread). The modules run on the fp2 curve instance (the goldens' one)
in both packages. Tolerance: exact equality."""
import hashlib
import json
import os

import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.coin import RandomCoin as JCoin
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine.coin import RandomCoin
from certificate_stark_tpu_torch.engine.hasher import get_hasher
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.engine.verifier import VerificationError
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops.field import P
from certificate_stark_tpu_torch.utils import curve as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = ("rescue_chain16_sha256", "rescue_chain16_sha3",
           "rescue_chain16_sha256_grind12", "transaction_2tx_d3_sha256")


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
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        g = json.load(f)[name]
    return g, ProofOptions(**g["options"])


def prove_golden(name):
    """(name, example, JAX air class and kwargs, coin journal, bytes) of
    the port's proof of one golden's statement."""
    g, opts = _golden(name)
    if name.startswith("transaction"):
        ex = TX.TransactionExample(g["num_transactions"], opts,
                                   depth=g["depth"], seed=g["seed"],
                                   device="cpu")
        jair = (JTX.TransactionAir, {"depth": g["depth"]})
    else:
        ex = RC.RescueChainExample(g["chain_length"], opts, device="cpu")
        jair = (JRC.RescueChainAir, {})
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    raw = prover.prove(ex.trace).to_bytes()
    return name, ex, jair, prover.coin_journal, raw


def check_golden(proven):
    name, ex, _, journal, raw = proven
    g, _ = _golden(name)
    if "initial_root" in g:
        assert [list(r) for r in ex.pub_inputs()] == [g["initial_root"],
                                                      g["final_root"]]
    else:
        assert ex.result == g["result"]
    assert [[kind, val] for kind, val in journal] == g["journal"]
    assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
    assert len(raw) == g["proof_len"]


def check_verifiers_accept(proven):
    name, ex, (air_class, kwargs), _, raw = proven
    _, opts = _golden(name)
    assert ex.verify(Proof.from_bytes(raw))
    assert JV.verify(air_class, JProof.from_bytes(raw), ex.pub_inputs(),
                     air_kwargs=kwargs,
                     expected_options=JOpts(**opts.__dict__))


def check_flipped_opening_rejected(proven):
    _, ex, (air_class, kwargs), _, raw = proven
    bad = Proof.from_bytes(raw)
    bad.queries[0].trace_row[1] = (bad.queries[0].trace_row[1] + 1) % P
    with pytest.raises(VerificationError):
        ex.verify(bad)
    with pytest.raises(JV.VerificationError):
        JV.verify(air_class, JProof.from_bytes(bad.to_bytes()),
                  ex.pub_inputs(), air_kwargs=kwargs)


@pytest.fixture(scope="module", params=GOLDENS)
def proven(request):
    return prove_golden(request.param)


def test_golden_reproduced(proven):
    check_golden(proven)


def test_both_verifiers_accept(proven):
    check_verifiers_accept(proven)


def test_flipped_opening_rejected_by_both(proven):
    check_flipped_opening_rejected(proven)


@pytest.mark.parametrize("hash_fn, bits", [("sha256", 11), ("sha256", 12),
                                           ("sha3", 11), ("sha3", 12)])
def test_grind_matches_jax_device_search_and_host_loop(hash_fn, bits):
    jh, h = JH.get_hasher(hash_fn), get_hasher(hash_fn)
    jcoin, coin = JCoin(jh, [3, 1, 4, 1, 5]), RandomCoin(h, [3, 1, 4, 1, 5])
    jcoin.reseed(jh.host_digest([9, 2, 6, bits]))
    coin.reseed(h.host_digest([9, 2, 6, bits]))
    assert coin.state == jcoin.state
    nonce = coin.grind(bits, device="cpu")
    assert nonce == jcoin._grind_device(bits, 1 << 26, batch=1 << 12)
    assert nonce == next(n for n in range(1 << 26)
                         if coin.check_pow(n, bits))
