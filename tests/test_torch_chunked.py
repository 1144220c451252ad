"""Domain-chunked proving of the port (engine/prover.py `chunk`), on the
CPU: the goldens `transaction_2tx_d3_blake3` and
`transaction_2tx_d3_cubic_blake3` (tests/vectors/torch_goldens.json, made
by the JAX package) proved in two segments of the 2^14-point domain (the
second segment's next-row frame wraps to the domain's start) equal the
golden's bytes and coin journal, and the JAX package's verifier accepts
them; and the trace LDE, `phase_composition` and `phase_deep` give the same
tensors at every chunk size as unchunked, over the base field and the cubic
extension. Tolerance: exact equality."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover, pick_chunk
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.utils import curve as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = ("transaction_2tx_d3_blake3", "transaction_2tx_d3_cubic_blake3")
# the rescue chain 16 (trace 14 x 128, blowup 4: 512 points, periodic
# block 32): every chunk size from the block to half the domain
CHAIN_CHUNKS = (32, 64, 256)


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
        return json.load(f)[name]


@pytest.fixture(scope="module", params=GOLDENS)
def chunked(request):
    """(golden, example, prover, coin journal, bytes) of the golden's
    statement proved with a chunk of half the domain."""
    g = _golden(request.param)
    ex = TX.TransactionExample(g["num_transactions"],
                               ProofOptions(**g["options"]),
                               depth=g["depth"], seed=g["seed"], device="cpu")
    air = ex.air()
    prover = Prover(air, device="cpu", chunk=air.trace_length * 4)
    prover.coin_journal = []
    raw = prover.prove(ex.trace).to_bytes()
    return g, ex, prover, prover.coin_journal, raw


def test_chunked_golden_has_two_segments(chunked):
    _, _, prover, _, _ = chunked
    assert prover.bn == 1 << 14 and prover.chunk == 1 << 13
    assert prover._segments() == [(0, 1 << 13), (1 << 13, 1 << 14)]
    assert tuple(prover.periodic.shape) == (48, 1 << 13)


def test_chunked_golden_reproduced(chunked):
    g, _, _, journal, raw = chunked
    assert [[kind, val] for kind, val in journal] == g["journal"]
    assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
    assert len(raw) == g["proof_len"]


def test_chunked_golden_passes_the_jax_verifier(chunked):
    g, ex, _, _, raw = chunked
    assert JV.verify(JTX.TransactionAir, JProof.from_bytes(raw),
                     ex.pub_inputs(), air_kwargs={"depth": g["depth"]},
                     expected_options=JOpts(**g["options"]))


def test_pick_chunk_rule():
    assert pick_chunk(1 << 20, 1 << 13) == 1 << 20       # default 2^20
    assert pick_chunk(1 << 23, 1 << 13) == 1 << 20
    assert pick_chunk(1 << 23, 1 << 13, 1 << 21) == 1 << 21
    assert pick_chunk(1 << 14, 1 << 13, 1) == 1 << 13     # raised to L
    assert pick_chunk(1 << 12, 32, 1 << 20) == 1 << 12    # bn: unchunked
    with pytest.raises(ValueError):
        pick_chunk(1 << 14, 32, 3 << 10)


def _rand(shape, rng):
    return F.from_ints(rng.integers(0, F.P, size=shape, dtype=np.int64)
                       .tolist(), "cpu")


@pytest.fixture(scope="module", params=(1, 3), ids=("d1", "d3"))
def unchunked(request):
    """The chain-16 statement over the extension of degree d, its
    unchunked prover, and seeded random protocol values: (prover, trace,
    the trace phase, composition inputs, the composition phase, DEEP
    inputs, the DEEP phase)."""
    d = request.param
    opts = ProofOptions(num_queries=8, blowup=4, hash_fn="blake3",
                        extension_degree=d)
    ex = RC.RescueChainExample(16, opts, device="cpu")
    prover = Prover(ex.air(), device="cpu")
    assert prover.chunk == prover.bn == 512
    rng = np.random.default_rng(20 + d)
    nc, nb = len(prover.degrees), len(prover.assertions)
    coeffs = [_rand((d, c), rng) for c in (nc, nc, nb, nb)]
    trace_phase = prover.phase_trace(ex.trace)
    comp_phase = prover.phase_composition(trace_phase[1], *coeffs)
    w, k = prover.w, prover.k
    deep_in = [_rand(shape, rng) for shape in
               ((d, w), (d, w), (d, k), (d, w), (d, w), (d, k), (d,))]
    deep = prover.phase_deep(trace_phase[1], comp_phase[1], *deep_in)
    return (prover, ex.trace, trace_phase, coeffs, comp_phase, deep_in,
            deep)


@pytest.mark.parametrize("chunk", CHAIN_CHUNKS)
def test_phases_equal_unchunked(unchunked, chunk):
    base, trace, trace_phase, coeffs, comp_phase, deep_in, deep = unchunked
    prover = Prover(base.air, device="cpu", chunk=chunk)
    assert prover.chunk == chunk and len(prover._segments()) == 512 // chunk
    coeffs_t, lde = prover.phase_trace(trace)
    assert torch.equal(coeffs_t, trace_phase[0])
    assert torch.equal(lde, trace_phase[1])
    h_coeffs, h_lde = prover.phase_composition(lde, *coeffs)
    assert torch.equal(h_coeffs, comp_phase[0])
    assert torch.equal(h_lde, comp_phase[1])
    got = prover.phase_deep(lde, h_lde, *deep_in)
    assert torch.equal(got, deep)
