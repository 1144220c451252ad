"""The 1024-transaction proof, on the CPU.

The port's proof of the composed AIR at 1024 transactions, depth 15
(bench.py's options; proven on an H100 in segments of 2^20 points,
chip_smoke.py `phase_tx1024`) is pinned in tests/vectors
(transaction_1024tx_d15_blake3.json and .proof): the JAX package's
verifier and the port's accept it with the public inputs of the JAX
package's seeded 1024-transaction witness (native C, seconds), and both
reject it with one query value flipped.

The trace kernel is held against its plain version at 1024 transactions
on the row blocks of a few transactions only, from the plain trace of the
packed inputs of those transactions (models/trace_device.py
`select_transactions`): here, at 4 transactions, depth 3, that trace
equals those transactions' row blocks of the whole plain trace.
Tolerance: exact equality."""
import hashlib
import json
import os

import pytest
import torch

from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine import verifier as V
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.models import trace_device as TD
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops.field import P
from certificate_stark_tpu_torch.utils import curve as CV

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "vectors")
T, DEPTH = 4, 3


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
    """The fp2 curve instance (the pinned proof's) in both packages."""
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    JCV.set_curve("fp2")
    CV.set_curve("fp2")
    yield
    JCV.set_curve(prev[0])
    CV.set_curve(prev[1])


@pytest.fixture(scope="module")
def packed():
    """(packed inputs, constants, the whole plain trace) of a seeded
    4-transaction witness at depth 3."""
    ex = TX.TransactionExample(T, ProofOptions(), depth=DEPTH, seed=9,
                               device="cpu")
    inputs, consts = TD.pack_witness(ex.md, ex.messages, "cpu")
    return inputs, consts, TD.build_trace_plain(inputs, consts, DEPTH)


@pytest.mark.parametrize("idx", ([0], [T - 1], [1, 2], [T - 1, 0]),
                         ids=("first", "last", "inside", "reordered"))
def test_selected_transactions_trace_equals_their_blocks(packed, idx):
    inputs, consts, full = packed
    got = TD.build_trace_plain(TD.select_transactions(inputs, idx), consts,
                               DEPTH)
    blocks = full.view(TX.TRACE_WIDTH, T, TX.CYCLE)[:, idx]
    assert torch.equal(got, blocks.reshape(TX.TRACE_WIDTH, -1))


@pytest.fixture(scope="module")
def tx1024():
    """(vector, proof bytes, public inputs of the JAX package's seeded
    1024-transaction witness)."""
    with open(os.path.join(VECTORS,
                           "transaction_1024tx_d15_blake3.json")) as f:
        vec = json.load(f)
    with open(os.path.join(VECTORS, vec["proof_file"]), "rb") as f:
        raw = f.read()
    assert vec["curve"] == JCV.CURVE_NAME
    ex = JTX.TransactionExample(vec["num_transactions"],
                                JOpts(**vec["options"]), depth=vec["depth"],
                                seed=vec["seed"])
    return vec, raw, tuple(list(r) for r in ex.pub_inputs())


def test_tx1024_vector_is_the_pinned_proof(tx1024):
    vec, raw, pub = tx1024
    assert hashlib.sha256(raw).hexdigest() == vec["proof_sha256"]
    assert len(raw) == vec["proof_len"]
    assert list(pub) == [vec["initial_root"], vec["final_root"]]
    proof = Proof.from_bytes(raw)
    assert (proof.trace_width, proof.trace_length) == (94, 1 << 20)
    assert proof.pub_inputs == vec["initial_root"] + vec["final_root"]


def _verify(which, vec, raw, pub):
    if which == "jax":
        return JV.verify(JTX.TransactionAir, JProof.from_bytes(raw), pub,
                         air_kwargs={"depth": vec["depth"]},
                         expected_options=JOpts(**vec["options"]))
    return V.verify(TX.TransactionAir, Proof.from_bytes(raw), pub,
                    air_kwargs={"depth": vec["depth"]},
                    expected_options=ProofOptions(**vec["options"]))


@pytest.mark.parametrize("which", ("jax", "port"))
def test_tx1024_proof_accepted(tx1024, which):
    assert _verify(which, *tx1024) is True


@pytest.mark.parametrize("which", ("jax", "port"))
def test_tx1024_flipped_query_value_rejected(tx1024, which):
    vec, raw, pub = tx1024
    proof = Proof.from_bytes(raw)
    row = proof.queries[0].trace_row
    row[1] = (row[1] + 1) % P
    with pytest.raises(Exception, match="^merkle"):
        _verify(which, vec, proof.to_bytes(), pub)
