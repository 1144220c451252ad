"""The port's engine and the rescue-chain slice against the JAX package, on
the CPU: Merkle trees, the rescue-chain trace and constraints, the coin, and
the whole proof of `rescue_chain16_rescue`, which must equal the committed
golden byte for byte and pass the JAX package's verifier and the port's. Tolerance: exact
equality."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine import merkle as JM
from certificate_stark_tpu.engine import verifier as JV
from certificate_stark_tpu.engine.coin import RandomCoin as JCoin
from certificate_stark_tpu.engine.fieldops import BASE as JBASE
from certificate_stark_tpu.engine.proof import Proof as JProof
from certificate_stark_tpu.models import rescue_chain as JRC
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu_torch.engine import merkle as M
from certificate_stark_tpu_torch.engine.boundary import build_boundary_tables
from certificate_stark_tpu_torch.engine.coin import RandomCoin
from certificate_stark_tpu_torch.engine.fieldops import BASE
from certificate_stark_tpu_torch.engine.hasher import RescueHasher
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.proof import Proof
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = JF.P


def test_merkle_roots_and_paths_match_jax():
    rng = np.random.default_rng(8)
    leaves_l = JF.from_int(rng.integers(0, P, size=(4, 256), dtype=np.uint64))
    jh = JH.RescueHasher()
    levels = jax.jit(lambda l: JM.MerkleTree(jh, l).levels)(
        jnp.asarray(leaves_l))
    jtree = JM.MerkleTree.from_levels(jh, levels)
    tree = M.MerkleTree.from_leaves(RescueHasher(), from_jax_limbs(leaves_l))
    assert tree.root() == jtree.root()
    idx = [0, 1, 77, 200, 255]
    assert M.prove_batch_multi([tree], [idx]) == \
        JM.prove_batch_multi([jtree], [idx])
    leaf = tuple(int(v) for v in JF.to_int(leaves_l[:, :, 77]))
    path = M.prove_batch_multi([tree], [[77]])[0][77]
    assert M.verify_path(RescueHasher(), tree.root(), 77, leaf, path)
    assert JM.verify_path(jh, jtree.root(), 77, leaf, path)


def test_build_trace_matches_jax():
    trace = RC.build_trace(RC.SEED, 16, "cpu")
    jtrace = np.asarray(JRC.build_trace(RC.SEED, 16))
    assert np.array_equal(to_jax_limbs(trace), jtrace)
    assert RC.compute_chain_result(RC.SEED, 16) == \
        JRC.compute_chain_result(RC.SEED, 16)


def test_evaluate_transition_matches_jax():
    opts = ProofOptions(num_queries=14, blowup=4, hash_fn="rescue")
    ex = RC.RescueChainExample(4, opts, device="cpu")
    prover = Prover(ex.air(), device="cpu")
    _, lde = prover.phase_trace(ex.trace)                   # [14, 128]
    nxt = torch.roll(lde, -prover.b, dims=-1)
    got = ex.air().evaluate_transition(BASE, lde, nxt, prover.periodic)
    jair = JRC.RescueChainAir(32, ex.pub_inputs(), opts)
    jper = np.tile(jair.periodic_lde(4, JF.GENERATOR), 128 // 32)
    assert np.array_equal(to_jax_limbs(prover.periodic), jper)
    exp = jair.evaluate_transition(
        JBASE, jnp.asarray(to_jax_limbs(lde)), jnp.asarray(to_jax_limbs(nxt)),
        jnp.asarray(jper))
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


def test_boundary_tables_match_jax():
    from certificate_stark_tpu.engine import boundary as JB
    from certificate_stark_tpu.engine import air as JA
    from certificate_stark_tpu_torch.engine import air as A
    n, b = 16, 4
    bn, g = n * b, JF.GENERATOR
    wt = pow(g, (P - 1) // n, P)
    mine = [A.Assertion(0, 0, 5), A.Assertion(2, 0, 6),
            A.Assertion(1, n - 1, 7), A.PeriodicAssertion(3, 1, 4, 9),
            A.SequenceAssertion(4, 2, 8, (1, 2))]
    theirs = [JA.Assertion(0, 0, 5), JA.Assertion(2, 0, 6),
              JA.Assertion(1, n - 1, 7), JA.PeriodicAssertion(3, 1, 4, 9),
              JA.SequenceAssertion(4, 2, 8, (1, 2))]
    gb = pow(g, (P - 1) // bn, P)
    xs_l = JF.mul_const(JF.np_powers(gb, bn), JF.np_const(g), np)
    comp_deg = 2 * n - 1
    got = build_boundary_tables(mine, n, bn, g, wt, comp_deg,
                                from_jax_limbs(xs_l))
    exp = JB.build_boundary_tables(theirs, n, bn, b, g, wt, comp_deg, xs_l)
    assert [t.key for t in got] == [t.key for t in exp]
    for t, e in zip(got, exp):
        assert t.adj == e.adj and list(t.columns) == list(e.columns)
        assert np.array_equal(to_jax_limbs(t.inv_z), e.inv_z)
        ev = t.b_evals.expand(-1, bn)
        assert np.array_equal(to_jax_limbs(ev), np.asarray(e.b_evals))


def test_coin_matches_jax():
    journal, jjournal = [], []
    coin = RandomCoin(RescueHasher(), [1, 2, 3], journal=journal)
    jcoin = JCoin(JH.RescueHasher(), [1, 2, 3], journal=jjournal)
    for c in (coin, jcoin):
        c.reseed((5, 6, 7, 8))
        c.draw_felts(3)
        c.draw_indices(12, 16)        # repeats are rejected
        c.grind(4)
    assert journal == jjournal
    assert coin.grind(6) == jcoin.grind(6)


@pytest.fixture(scope="module")
def chain16():
    """The slice as a whole: the port proves rescue_chain16_rescue."""
    opts = ProofOptions(num_queries=14, blowup=4, hash_fn="rescue")
    ex = RC.RescueChainExample(16, opts, device="cpu")
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    proof = prover.prove(ex.trace)
    return ex, prover.coin_journal, proof.to_bytes()


def test_chain16_proof_equals_golden(chain16):
    _, journal, raw = chain16
    with open(os.path.join(ROOT, "tests", "vectors", "transcripts.json")) as f:
        golden = json.load(f)["rescue_chain16_rescue"]
    assert [[kind, val] for kind, val in journal] == golden["journal"]
    assert hashlib.sha256(raw).hexdigest() == golden["proof_sha256"]
    assert len(raw) == golden["proof_len"] == 15668


def test_chain16_proof_passes_jax_verifier(chain16):
    ex, _, raw = chain16
    assert JV.verify(JRC.RescueChainAir, JProof.from_bytes(raw),
                     ex.pub_inputs())


def test_chain16_proof_passes_port_verifier(chain16):
    ex, _, raw = chain16
    assert ex.verify(Proof.from_bytes(raw))


def test_chain16_tampered_proof_fails_jax_verifier(chain16):
    ex, _, raw = chain16
    proof = JProof.from_bytes(raw)
    proof.queries[3].trace_row[5] = (proof.queries[3].trace_row[5] + 1) % P
    with pytest.raises(JV.VerificationError):
        JV.verify(JRC.RescueChainAir, proof, ex.pub_inputs())


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib, pkgutil, sys
before = set(sys.modules)
import certificate_stark_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401
# the modules of the extension, verifier and grinding slice, the CLI too,
# the standalone AIR programs with their trace functions, the SHA
# hashers and phase checkpoints, and the sharded prover
need = {"certificate_stark_tpu_torch." + m for m in (
    "params.extensions", "ops.extfield", "engine.fieldops", "engine.coin",
    "engine.fri", "engine.verifier", "examples.state_transition",
    "models.range", "models.merkle_init", "models.merkle_update",
    "models.schnorr", "models.trace_device", "utils.curve",
    "utils.curve_batch", "utils.field_ref", "ops.sha256", "ops.sha3",
    "engine.checkpoint", "parallel.mesh", "parallel.ntt",
    "parallel.prover")}
assert need <= set(sys.modules), sorted(need - set(sys.modules))
new = set(sys.modules) - before
bad = sorted(m for m in new if m == "jax" or m.startswith("jax.")
             or m == "certificate_stark_tpu"
             or m.startswith("certificate_stark_tpu."))
print(len(new), bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, ROOT], cwd=ROOT,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opts = ProofOptions(num_queries=14, blowup=4, hash_fn="rescue")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RC.RescueChainExample(16, opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RC.build_trace(RC.SEED, 4)
    air = RC.RescueChainAir(128, (RC.SEED, [0] * 7), opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prover(air)

