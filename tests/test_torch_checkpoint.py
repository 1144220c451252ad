"""Phase checkpoints of the port's prover (engine/checkpoint.py,
`Prover.prove(..., checkpoint=prover.checkpointer(directory))`), the port
of tests/test_checkpoint.py's first two cases, on the CPU: a proof resumed
after any completed phase, or from every phase with a zero trace, is the
same bytes as the proof made at once (and the JAX package's verifier
accepts it); artifacts saved under another context are not read; and a
directory the JAX package's prover checkpointed for the same statement is
not resumed. The statement is the rescue chain of 64 with SHA3-256
commitments and 4 bits of grinding: an LDE of 2^11 points, so two FRI
layers. A second statement resumes over the cubic extension (rescue
chain 16, BLAKE3, the example CLI's field), where the OOD values, the
DEEP composition and the FRI groups carry an extension axis. Tolerance:
exact equality."""
import os
import shutil

import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import prover as JPR
from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.checkpoint import Checkpointer as JCheckpointer
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu_torch.engine.checkpoint import Checkpointer
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC

OPTS = dict(num_queries=8, blowup=4, hash_fn="sha3", grinding_bits=4)
CHAIN = 64
# statement -> (chain length, options, its checkpointed phases)
STATEMENTS = {
    "chain64_sha3": (CHAIN, OPTS, ("trace", "composition", "deep", "fri0",
                                   "fri1", "pow")),
    "chain16_cubic_blake3": (16, dict(num_queries=8, blowup=4,
                                      hash_fn="blake3", extension_degree=3,
                                      grinding_bits=4),
                             ("trace", "composition", "deep", "fri0", "pow")),
}
PHASES = STATEMENTS["chain64_sha3"][2]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpointed_of(tmp_path_factory):
    """statement -> (example, proof bytes made at once, a directory holding
    every phase's checkpoint of the same proof, the phases, the options),
    each statement proven once for the module."""
    made = {}

    def get(name):
        if name not in made:
            chain, opts, phases = STATEMENTS[name]
            ex = RC.RescueChainExample(chain, ProofOptions(**opts),
                                       device="cpu")
            prover = Prover(ex.air(), device="cpu")
            ref = prover.prove(ex.trace).to_bytes()
            d = tmp_path_factory.mktemp("ck")
            assert prover.prove(ex.trace, checkpoint=prover.checkpointer(
                str(d))).to_bytes() == ref
            assert {f"{k}.npz" for k in phases} | {"MANIFEST.json"} == \
                set(os.listdir(d))
            made[name] = ex, ref, d, phases, opts
        return made[name]
    return get


@pytest.fixture(scope="module")
def checkpointed(checkpointed_of):
    return checkpointed_of("chain64_sha3")


def _resume(ex, directory, trace):
    prover = Prover(ex.air(), device="cpu")
    return prover.prove(trace, checkpoint=prover.checkpointer(
        str(directory))).to_bytes()


@pytest.mark.parametrize("statement, kept", [
    (name, kept) for name, (_, _, phases) in STATEMENTS.items()
    for kept in range(len(phases) + 1)])
def test_resume_after_each_phase(checkpointed_of, tmp_path, statement, kept):
    """Only the first `kept` phases' files are left: those phases are read
    (with a zero trace, once the trace phase is kept) and the others
    computed; the bytes are the same."""
    ex, ref, d, phases, _ = checkpointed_of(statement)
    for key in phases[:kept]:
        shutil.copy(d / f"{key}.npz", tmp_path)
    shutil.copy(d / "MANIFEST.json", tmp_path)
    trace = torch.zeros_like(ex.trace) if kept else ex.trace
    assert _resume(ex, tmp_path, trace) == ref
    # the phases computed on resume were checkpointed again
    assert {f"{k}.npz" for k in phases} <= set(os.listdir(tmp_path))


@pytest.mark.parametrize("statement", list(STATEMENTS))
def test_zero_trace_resume_passes_the_jax_verifier(checkpointed_of,
                                                   statement):
    ex, ref, d, _, opts = checkpointed_of(statement)
    raw = _resume(ex, d, torch.zeros_like(ex.trace))
    assert raw == ref
    assert JV.verify(JRC.RescueChainAir, JProof.from_bytes(raw),
                     ex.pub_inputs(), expected_options=JOpts(**opts))


def test_context_mismatch_not_resumed(tmp_path):
    a = Checkpointer(str(tmp_path), context=["A", 1], device="cpu")
    a.save("trace", x=torch.arange(3), n=7)
    b = Checkpointer(str(tmp_path), context=["B", 2], device="cpu")
    assert b.load("trace") is None          # another context: ignored
    got = Checkpointer(str(tmp_path), context=["A", 1],
                       device="cpu").load("trace")
    assert torch.equal(got["x"], torch.arange(3)) and int(got["n"]) == 7
    assert got["x"].dtype == torch.int64


def test_default_device_is_the_card(tmp_path):
    """Like every entry point of the port, a Checkpointer made without a
    device loads onto the card: where there is none it raises, and never
    falls back to the CPU."""
    if torch.cuda.is_available():
        assert Checkpointer(str(tmp_path)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Checkpointer(str(tmp_path))


def test_other_statement_not_resumed(checkpointed, tmp_path):
    """A checkpoint of another chain length (another trace, public inputs
    and context) in the directory is recomputed over, not read."""
    ex, ref, _, _, _ = checkpointed
    other = RC.RescueChainExample(CHAIN // 2, ProofOptions(**OPTS),
                                  device="cpu")
    prover = Prover(other.air(), device="cpu")
    prover.prove(other.trace, checkpoint=prover.checkpointer(str(tmp_path)))
    mine = Prover(ex.air(), device="cpu").checkpointer(str(tmp_path))
    assert all(mine.load(key) is None for key in PHASES)
    assert _resume(ex, tmp_path, ex.trace) == ref


def test_jax_checkpoint_directory_not_resumed(checkpointed, tmp_path):
    """The JAX package's prover hashes the same context list (AIR name,
    shape, options, public inputs, hasher) for the same statement; the
    port's format tag keeps its uint32 limb artifacts unread."""
    ex, ref, _, _, _ = checkpointed
    jopts = JOpts(**OPTS)
    jprover = JPR.Prover(JRC.RescueChainAir(CHAIN * 8, ex.pub_inputs(),
                                            jopts))
    jck = jprover.checkpointer(str(tmp_path))
    w, n, bn = 14, CHAIN * 8, CHAIN * 8 * 4
    limbs = np.zeros((4, w, bn), dtype=np.uint32)
    jck.save_levels("trace", {"trace_coeffs": limbs[:, :, :n], "lde": limbs,
                              "packed": np.asarray(0)}, [limbs[:, :8]])
    jck.save("pow", nonce=np.asarray(0, dtype=np.uint64))
    assert jck.load("trace") is not None
    prover = Prover(ex.air(), device="cpu")
    ck = prover.checkpointer(str(tmp_path))
    assert ck.load("trace") is None and ck.load("pow") is None
    # the same context list: only the format tag tells the two apart
    assert JCheckpointer(str(tmp_path / "x"), context=[
        type(ex.air()).__name__, w, n, jopts.context_elements(w, n),
        ex.air().pub_inputs_elements(), "sha3"]).ctx == jck.ctx
    assert prover.prove(ex.trace, checkpoint=ck).to_bytes() == ref
