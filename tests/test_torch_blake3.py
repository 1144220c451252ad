"""The port's BLAKE3 commitment path against the JAX package, on the CPU:
the plain version of the csrc/blake3.cu kernels (leaf hashes of 94-, 8- and
4-element rows, merges), the host hash of the coin, Merkle roots and paths
of `Blake3Hasher`, the BLAKE3 coin's journal, and the whole BLAKE3 proof of
the rescue chain of 16 against its golden. Inputs are seeded numpy arrays
fed to both packages. Tolerance: exact equality."""
import hashlib
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine import merkle as JM
from certificate_stark_tpu.engine.coin import RandomCoin as JCoin
from certificate_stark_tpu.ops import blake3 as JB
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu_torch.engine import merkle as M
from certificate_stark_tpu_torch.engine.coin import RandomCoin
from certificate_stark_tpu_torch.engine.hasher import Blake3Hasher, get_hasher
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops import blake3 as B
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.utils.convert import from_jax_limbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = JF.P


def _felts(k, b, seed):
    """[4, k, b] JAX Montgomery limbs of seeded random elements."""
    vals = np.random.default_rng(seed).integers(0, P, size=(k, b),
                                                dtype=np.uint64)
    return JF.from_int(vals)


@pytest.mark.parametrize("k", [94, 8, 4, 1])
def test_leaf_hashes_match_jax_numpy_path(k):
    limbs = _felts(k, 37, k)
    std = JF.to_int(limbs)                              # [k, 37] ints
    std_limbs = JF.from_int(std, mont=False)
    exp = JB.blake3_words(JB.felems_to_words_le(std_limbs, xp=np), xp=np)
    got = K.blake3_leaves_plain(from_jax_limbs(limbs))
    assert np.array_equal(got.numpy(), exp.astype(np.int64))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(K.blake3_leaves(from_jax_limbs(limbs)), got)
    # each row is the full BLAKE3 of its 8k bytes
    for j in (0, 36):
        data = b"".join(int(v).to_bytes(8, "little") for v in std[:, j])
        assert tuple(got[:, j].tolist()) == JB.digest_words(data)


@pytest.mark.parametrize("m", [1, 2, 33])
def test_merges_match_jax_numpy_path(m):
    level = np.random.default_rng(m).integers(0, 1 << 32, size=(8, 2 * m),
                                              dtype=np.uint64)
    both = np.concatenate([level[:, 0::2], level[:, 1::2]]).astype(np.uint32)
    exp = JB.blake3_words(both, xp=np)
    got = K.blake3_merge_plain(torch.from_numpy(level.astype(np.int64)))
    assert np.array_equal(got.numpy(), exp.astype(np.int64))
    assert torch.equal(K.blake3_merge(torch.from_numpy(
        level.astype(np.int64))), got)


@pytest.mark.parametrize("length", [0, 1, 64, 65, 1024, 1025, 1568, 2048,
                                    4100])
def test_host_hash_matches_jax(length):
    data = np.random.default_rng(length).bytes(length)
    assert B.blake3_bytes(data) == JB.blake3_bytes(data)
    assert B.digest_words(data) == JB.digest_words(data)


def test_host_digest_and_merge_match_jax():
    h, jh = Blake3Hasher(), JH.Blake3Hasher()
    elems = [int(v) for v in np.random.default_rng(5).integers(
        0, P, size=200, dtype=np.uint64)]
    assert h.host_digest(elems) == jh.host_digest(elems)
    d0, d1 = h.host_digest(elems[:3]), h.host_digest(elems[3:9])
    assert h.host_merge(d0, d1) == jh.host_merge(d0, d1)
    assert get_hasher("blake3").name == "blake3"


def test_merkle_roots_and_paths_match_jax():
    jh = JH.Blake3Hasher()
    limbs = _felts(94, 64, 11)
    leaves = jax.jit(jh.hash_columns)(jnp.asarray(limbs))
    levels = jax.jit(lambda l: JM.MerkleTree(jh, l).levels)(leaves)
    jtree = JM.MerkleTree.from_levels(jh, levels)
    h = Blake3Hasher()
    tree = M.MerkleTree.from_leaves(h, h.hash_columns(from_jax_limbs(limbs)))
    assert np.array_equal(tree.levels[0].numpy(),
                          np.asarray(leaves).astype(np.int64))
    assert tree.root() == jtree.root()
    idx = [0, 1, 17, 63]
    paths = M.prove_batch_multi([tree], [idx])
    assert paths == JM.prove_batch_multi([jtree], [idx])
    leaf = h.to_host(tree.levels[0][:, 17:18])[0]
    assert M.verify_path(h, tree.root(), 17, leaf, paths[0][17])
    assert JM.verify_path(jh, jtree.root(), 17, leaf, paths[0][17])


def test_coin_journal_matches_jax():
    journal, jjournal = [], []
    coin = RandomCoin(Blake3Hasher(), [9, 8, 7, 6], journal=journal)
    jcoin = JCoin(JH.Blake3Hasher(), [9, 8, 7, 6], journal=jjournal)
    for c in (coin, jcoin):
        c.reseed(tuple(range(8)))
        c.draw_felts(5)
        c.draw_indices(30, 64)          # repeats are rejected
        c.reseed(c.h.host_digest([1, 2, 3]))
        c.draw_felt()
    assert journal == jjournal
    for bits in (0, 3, 6):
        assert coin.grind(bits) == jcoin.grind(bits)
        assert coin.check_pow(coin.grind(bits), bits)


def test_rescue_chain16_blake3_proof_equals_golden():
    """The whole BLAKE3 proof path on a small AIR: the rescue chain of 16
    with BLAKE3 commitments equals tests/vectors/transcripts.json."""
    with open(os.path.join(ROOT, "tests", "vectors", "transcripts.json")) as f:
        golden = json.load(f)["rescue_chain16_blake3"]
    ex = RC.RescueChainExample(
        16, ProofOptions(num_queries=14, blowup=4, hash_fn="blake3"),
        device="cpu")
    prover = Prover(ex.air(), device="cpu")
    prover.coin_journal = []
    raw = prover.prove(ex.trace).to_bytes()
    assert [[k, v] for k, v in prover.coin_journal] == golden["journal"]
    assert hashlib.sha256(raw).hexdigest() == golden["proof_sha256"]
    assert len(raw) == golden["proof_len"] == 26964
