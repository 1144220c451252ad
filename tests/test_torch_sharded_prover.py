"""The port's sharded prover (certificate_stark_tpu_torch/parallel/prover.py
`ShardedProver`) on the CPU: eight gloo ranks spawned once for the module
(one torch thread each) prove, at D = 4 on two process groups of four of
them and at D = 8 on all of them:

  * the goldens `transaction_2tx_d3_blake3` (tests/vectors/
    torch_goldens.json; a rank's 4096-point block is shorter than the AIR's
    8192-point periodic block), `rescue_chain16_blake3` (D = 4 and 8) and
    `rescue_chain16_rescue` and `rescue_chain16_cubic_grind4` (the cubic
    extension, its 4-bit nonce found by rank 0 and broadcast)
    (tests/vectors/transcripts.json, made by the JAX package), and
    `rescue_chain16_blake3` by each rank alone (D = 1):
    the same bytes and coin journal on every rank;
  * the chain-16 quadratic-extension statement of the JAX package's
    tests/test_sharded_prover.py, and chain 2 at D = 8 (its 16-point trace
    does not split over 8 ranks, so the trace iNTT and the size-16
    transforms of the LDE run locally; FRI folds by 2 down to 4 values, so
    its last layers have fewer leaves than ranks and run replicated): the
    single-device proof's bytes and coin journal;

and the JAX package's verifier accepts the sharded proofs. The ranks also
check that `make_mesh` refuses nccl over a gloo group and the CUDA default
without a card, that checkpoints are refused, and compute
`sharded_prove_core`'s composition leaves. Tolerance: exact equality.

The ranks import this module, so JAX is imported by the tests only."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.parallel import mesh as PM
from certificate_stark_tpu_torch.parallel import ntt as PN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TX_GOLDEN = "transaction_2tx_d3_blake3"
CHAIN16_BLAKE3 = dict(num_queries=14, blowup=4, hash_fn="blake3")
# case -> (process group: "a" ranks 0-3, "b" ranks 4-7, "all" ranks 0-7,
# "one" each rank alone;
# the statement; its options; the golden it must equal, or None for the
# single-device proof)
CASES = {
    "tx2_d3_blake3_D4": ("a", "tx", None, TX_GOLDEN),
    "chain16_blake3_D4": ("b", 16, CHAIN16_BLAKE3, "rescue_chain16_blake3"),
    "chain16_rescue_D4": ("b", 16, dict(num_queries=14, blowup=4,
                                         hash_fn="rescue"),
                          "rescue_chain16_rescue"),
    "chain16_cubic_grind4_D4": ("b", 16, dict(
        num_queries=8, blowup=4, hash_fn="blake3", extension_degree=3,
        grinding_bits=4), "rescue_chain16_cubic_grind4"),
    "chain16_quadratic_D4": ("b", 16, dict(
        num_queries=4, blowup=4, grinding_bits=0, hash_fn="blake3",
        extension_degree=2, fri_folding=4, fri_max_remainder=256), None),
    "chain16_blake3_D8": ("all", 16, CHAIN16_BLAKE3,
                          "rescue_chain16_blake3"),
    "chain16_blake3_D1": ("one", 16, CHAIN16_BLAKE3, "rescue_chain16_blake3"),
    "chain2_fold2_D8": ("all", 2, dict(num_queries=8, blowup=4,
                                        hash_fn="blake3", fri_folding=2,
                                        fri_max_remainder=4), None),
}
CORE_SEED = 5


def _golden(name):
    for f in ("transcripts.json", "torch_goldens.json"):
        with open(os.path.join(ROOT, "tests", "vectors", f)) as fh:
            data = json.load(fh)
        if name in data:
            return data[name]
    raise KeyError(name)


def _core_coeffs(prover):
    """Seeded composition coefficients (t_alpha, t_beta, b_alpha,
    b_beta) for sharded_prove_core."""
    rng = np.random.default_rng(CORE_SEED)
    nc, nb, d = len(prover.degrees), len(prover.assertions), prover.d
    return [F.from_ints(rng.integers(0, F.P, size=(d, c), dtype=np.int64)
                        .tolist(), "cpu") for c in (nc, nc, nb, nb)]


def _ranks(mesh, tx):
    """Every case on its process group -> {case: (proof bytes, coin
    journal)}, with the checks' results."""
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.parallel.prover import ShardedProver
    from certificate_stark_tpu_torch.utils import curve as CV
    torch.set_num_threads(1)
    CV.set_curve("fp2")
    groups = [dist.new_group(list(range(g, g + 4))) for g in (0, 4)]
    alone = [dist.new_group([r]) for r in range(8)]
    meshes = {"all": mesh, "ab"[mesh.rank // 4]:
              PM.make_mesh("cpu", "gloo", group=groups[mesh.rank // 4]),
              "one": PM.make_mesh("cpu", "gloo", group=alone[mesh.rank])}
    out = {}
    for name, (group, chain, od, _) in CASES.items():
        if group not in meshes:
            continue
        if chain == "tx":
            g = _golden(TX_GOLDEN)
            air = TX.TransactionAir(tx["trace"].shape[1], tx["pub_inputs"],
                                    ProofOptions(**g["options"]), depth=3)
            trace = torch.from_numpy(tx["trace"])
        else:
            ex = RC.RescueChainExample(chain, ProofOptions(**od),
                                       device="cpu")
            air, trace = ex.air(), ex.trace
        prover = ShardedProver(air, meshes[group])
        prover.coin_journal = []
        raw = prover.prove(trace).to_bytes()
        out[name] = (raw, prover.coin_journal)
        if chain == "tx":
            out["tx_block"] = (prover.j_hi - prover.j_lo,
                               air.periodic_lde(prover.b, prover.offset,
                                                "cpu").shape[-1])
    if "b" in meshes:
        ex = RC.RescueChainExample(16, ProofOptions(**CHAIN16_BLAKE3),
                                   device="cpu")
        prover = ShardedProver(ex.air(), meshes["b"])
        leaves = PM.sharded_prove_core(prover, ex.trace,
                                       *_core_coeffs(prover))
        out["core"] = prover._gather(leaves).numpy()
        with pytest.raises(NotImplementedError, match="checkpoints"):
            prover.prove(ex.trace, checkpoint=object())
    with pytest.raises(ValueError, match="'nccl' named, but the process "
                       "group runs 'gloo'"):
        PM.make_mesh(backend="nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh()
    out["refused"] = True
    return out


@pytest.fixture(scope="module")
def tx_statement():
    """The 2-transaction golden's example (fp2 curve), its trace built
    once here for the ranks."""
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.utils import curve as CV
    g = _golden(TX_GOLDEN)
    prev = CV.CURVE_NAME
    CV.set_curve("fp2")
    try:
        ex = TX.TransactionExample(g["num_transactions"],
                                   ProofOptions(**g["options"]),
                                   depth=g["depth"], seed=g["seed"],
                                   device="cpu")
        return ex, {"trace": ex.trace.numpy(), "pub_inputs": ex.pub_inputs()}
    finally:
        CV.set_curve(prev)


@pytest.fixture(scope="module")
def ranks(tx_statement):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return PM.launch(_ranks, 8, "gloo", device="cpu",
                         args=(tx_statement[1],), timeout=600)
    finally:
        torch.set_num_threads(prev)


def _holders(ranks, name):
    group = CASES[name][0]
    return {"a": ranks[:4], "b": ranks[4:]}.get(group, ranks)


def _single(name):
    """The single-device prover's (bytes, journal) for a chain case."""
    _, chain, od, _ = CASES[name]
    ex = RC.RescueChainExample(chain, ProofOptions(**od), device="cpu")
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    return prover.prove(ex.trace).to_bytes(), prover.coin_journal


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3]])
def test_sharded_proof_equals_golden(ranks, name):
    g = _golden(CASES[name][3])
    for out in _holders(ranks, name):
        raw, journal = out[name]
        assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
        assert len(raw) == g["proof_len"]
        assert [[kind, val] for kind, val in journal] == g["journal"]


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if not c[3]])
def test_sharded_proof_equals_single_device(ranks, name):
    raw, journal = _single(name)
    for out in _holders(ranks, name):
        assert out[name][0] == raw
        assert out[name][1] == journal


def _jax_verify(name, raw, tx_statement):
    from certificate_stark_tpu.engine import verifier as JV
    from certificate_stark_tpu.engine.options import ProofOptions as JOpts
    from certificate_stark_tpu.engine.proof import Proof as JProof
    from certificate_stark_tpu.models import rescue_chain as JRC
    from certificate_stark_tpu.models import transaction as JTX
    from certificate_stark_tpu.utils import curve as JCV
    proof = JProof.from_bytes(raw)
    _, chain, od, _ = CASES[name]
    if chain == "tx":
        g = _golden(TX_GOLDEN)
        prev = JCV.CURVE_NAME
        JCV.set_curve("fp2")
        try:
            return JV.verify(JTX.TransactionAir, proof,
                             tx_statement[0].pub_inputs(),
                             air_kwargs={"depth": g["depth"]},
                             expected_options=JOpts(**g["options"]))
        finally:
            JCV.set_curve(prev)
    ex = RC.RescueChainExample(chain, ProofOptions(**od), device="cpu")
    return JV.verify(JRC.RescueChainAir, proof, ex.pub_inputs(),
                     expected_options=JOpts(**od))


@pytest.mark.parametrize("name", ["tx2_d3_blake3_D4", "chain16_quadratic_D4",
                                  "chain2_fold2_D8"])
def test_jax_verifier_accepts_sharded_proof(ranks, tx_statement, name):
    assert _jax_verify(name, _holders(ranks, name)[-1][name][0],
                       tx_statement)


def test_block_shorter_than_periodic_block(ranks):
    # 2 tx at depth 3: 16384 points over 4 ranks, periodic block 8 x 1024
    assert ranks[0]["tx_block"] == (4096, 8192)


def test_short_trace_falls_back_to_local_transforms():
    # chain 2: 16 trace rows (4 x 4) do not split over 8 ranks; its
    # 64-point composition domain (8 x 8) does; chain 16's 128 rows do
    assert not PN.splits(16, 8) and PN.splits(64, 8)
    assert PN.splits(128, 8) and PN.splits(128, 4)


def test_sharded_prove_core_matches_single_device(ranks):
    ex = RC.RescueChainExample(16, ProofOptions(**CHAIN16_BLAKE3),
                               device="cpu")
    prover = Prover(ex.air(), device="cpu")
    _, lde = prover.phase_trace(ex.trace)
    _, h_lde = prover.phase_composition(lde, *_core_coeffs(prover))
    exp = prover.hasher.hash_columns(
        h_lde.transpose(0, 1).reshape(prover.k * prover.d, prover.bn))
    for out in ranks[4:]:
        assert np.array_equal(out["core"], exp.numpy())


def test_ranks_refuse_nccl_over_gloo_and_cuda_default(ranks):
    assert all(out["refused"] for out in ranks)


def test_launcher_and_mesh_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="nccl moves CUDA tensors only"):
        PM.launch(_ranks, 4, "nccl", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.launch(_ranks, 4, "nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.launch(_ranks, 4, "gloo")
    with pytest.raises(RuntimeError, match="initialised process group"):
        PM.make_mesh(device="cpu", backend="gloo")
