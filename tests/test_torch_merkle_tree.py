"""Whole Merkle trees in one buffer (ops/kernels.py `tree_plain`,
`tree_schedule`, `blake3_tree` / `sha256_tree` / `sha3_tree`;
engine/hasher.py `merge_tree`), on the CPU: the plain tree of BLAKE3,
SHA-256 and SHA3-256 against the JAX package's `tree_levels` with its own
hashers, level by level; a model of the tree kernels' schedule
(csrc/tree.cuh: one block a subtree, the last block of each group going
on) against the level-by-level tree; a Python-int model of csrc/sha256.cu's
merge (its pad block from the source's constant table) against hashlib and
the plain merge; authentication paths from the buffer's views against
separate level tensors; and a checkpoint written with separate levels,
resumed into the same proof bytes. Inputs are seeded numpy arrays fed to
both packages. Tolerance: exact equality."""
import hashlib
import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine import kernels as JK
from certificate_stark_tpu_torch.engine import merkle as M
from certificate_stark_tpu_torch.engine.hasher import (Blake3Hasher,
                                                        Sha256Hasher,
                                                        Sha3Hasher,
                                                        get_hasher)
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import rescue_chain as RC
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops import sha256 as S2

HASHES = {"blake3": (Blake3Hasher, JH.Blake3Hasher, K.blake3_merge_plain,
                     K.blake3_tree),
          "sha256": (Sha256Hasher, JH.Sha256Hasher, K.sha256_merge_plain,
                     K.sha256_tree),
          "sha3": (Sha3Hasher, JH.Sha3Hasher, K.sha3_merge_plain,
                   K.sha3_tree)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(n, seed):
    """[8, n] seeded random u32 digest words (numpy)."""
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(8, n),
                                                dtype=np.uint64)


def _per_level(merge, leaves):
    levels = [leaves]
    while levels[-1].shape[1] > 1:
        levels.append(merge(levels[-1]))
    return levels


@pytest.mark.parametrize("hash_fn", list(HASHES))
@pytest.mark.parametrize("n", [1, 2, 8, 64, 1 << 11])
def test_plain_tree_matches_jax_tree_levels(hash_fn, n):
    cls, jcls, merge_plain, tree = HASHES[hash_fn]
    words = _leaves(n, n)
    exp = JK.tree_levels(jcls(), jnp.asarray(words.astype(np.uint32)))
    leaves = torch.from_numpy(words.astype(np.int64))
    buf = K.tree_plain(merge_plain, leaves)
    assert buf.shape == (8, n - 1)
    got = [leaves] + K.tree_levels_of(buf)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), np.asarray(e).astype(np.int64))
    # the wrapper and the hasher take the plain tree for a CPU tensor
    assert torch.equal(tree(leaves), buf)
    assert tree.launches == 0
    levels = M.tree_levels(cls(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(levels, got))


def _mix_merge(level):
    """A cheap stand-in merge for the schedule model: [8, 2m] -> [8, m],
    every output word depending on both children and on its word index."""
    a, b = level[:, 0::2], level[:, 1::2]
    w = torch.arange(1, 9, dtype=torch.int64)[:, None]
    x = (a * 0x9E3779B1 + b.roll(1, 0) * 0x85EBCA77 + w) & K.M32
    return (x ^ (x >> 15) ^ b) & K.M32


def _schedule_model(merge, leaves, s, seed):
    """The tree kernels' control flow on the CPU: stage 0's blocks run in a
    shuffled order, each hashing its subtree level by level into the
    buffer's columns; a finished block counts itself at its gate and only
    the last of each group goes on to hash the group's roots."""
    n = leaves.shape[1]
    stages = K.tree_schedule(n, s)
    buf = torch.full((8, n - 1), -1, dtype=torch.int64)
    ctr = [0] * sum(st.m // st.size for st in stages[1:])

    def block(unit):
        for i, st in enumerate(stages):
            if i > 0:
                c = st.ctr + unit // st.size
                ctr[c] += 1
                if ctr[c] != st.size:
                    return
                unit //= st.size
            c0 = st.src_col + unit * st.size
            cur = (leaves if i == 0 else buf)[:, c0:c0 + st.size]
            cout = st.m
            for _ in range(st.levels):
                cur = merge(cur)
                cout //= 2
                o0 = n - 2 * cout + unit * cur.shape[1]
                buf[:, o0:o0 + cur.shape[1]] = cur

    units = list(range(stages[0].m // stages[0].size)) if stages else []
    random.Random(seed).shuffle(units)
    for u in units:
        block(u)
    assert all(c == st.size for st in stages[1:]
               for c in ctr[st.ctr:st.ctr + st.m // st.size])
    return buf


@pytest.mark.parametrize("s", [2, 3, 4])
def test_schedule_model_equals_level_by_level(s):
    sizes = sorted({1, 2, 1 << (s - 1), 1 << s, 1 << (s + 1),
                    1 << (2 * s - 1), 1 << (2 * s), 1 << (2 * s + 1),
                    1 << 12})
    for n in sizes:
        leaves = torch.from_numpy(_leaves(n, s * 100 + n).astype(np.int64))
        got = _schedule_model(_mix_merge, leaves, s, seed=n)
        assert torch.equal(got, K.tree_plain(_mix_merge, leaves)), (s, n)
    # and with BLAKE3's plain merge, over several stages
    leaves = torch.from_numpy(_leaves(64, 7).astype(np.int64))
    assert torch.equal(_schedule_model(K.blake3_merge_plain, leaves, s, 1),
                       K.tree_plain(K.blake3_merge_plain, leaves))


@pytest.mark.parametrize("n", [1, 2, 1 << 10, 1 << 11, 1 << 18, 1 << 19,
                               1 << 20, 1 << 21, 1 << 22, 1 << 23])
def test_schedule_shape(n):
    """Stages of the kernels' schedule: ceil(log2 n / s) of them (one
    launch whatever the count), s = 11, or 10 below 2^19 leaves; each
    subtree at most 2^s digests, each stage over the roots of the one
    before, the gate counters disjoint."""
    stages = K.tree_schedule(n)
    L = n.bit_length() - 1
    s = 10 if n < 1 << 19 else 11
    assert len(stages) == -(-L // s) <= -(-L // 10)
    assert all(st.size <= 1 << s for st in stages)
    assert sum(st.levels for st in stages) == L
    m, ctr = n, 0
    for i, st in enumerate(stages):
        assert st.m == m and st.size == 1 << st.levels <= 1 << K.TREE_LOG2
        assert st.src_col == (0 if i == 0 else n - 2 * m)
        if i:
            assert st.ctr == ctr
            ctr += m // st.size
        m //= st.size
    assert m == 1


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        K.tree_schedule(12)
    with pytest.raises(ValueError):
        K.blake3_tree(torch.zeros((8, 4), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        K._tree(K.sha3_tree, "sha3",
                torch.zeros((8, 4), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        K.sha256_tree(torch.zeros((8, 4), dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("hash_fn", list(HASHES))
def test_tree_wrappers_refuse_other_leaf_shapes(hash_fn):
    """A leaf count that is not a power of two, or not 8 words a digest,
    is refused on the CPU as on the card."""
    tree = HASHES[hash_fn][3]
    for shape in ((8, 12), (8, 0), (4, 8)):
        with pytest.raises(ValueError):
            tree(torch.zeros(shape, dtype=torch.int64))
        with pytest.raises(ValueError):
            K._tree(tree, hash_fn, torch.zeros(shape, dtype=torch.int64,
                                               device="meta"))


def _pad_kw_of_source():
    """csrc/sha256.cu's PAD_KW table: K[i] + W[i] of the pad block."""
    with open(os.path.join(K.CSRC, "sha256.cu")) as f:
        body = re.search(r"PAD_KW\[64\] = \{([^}]*)\}", f.read()).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]


def _rounds_kw(state, kw):
    """csrc/sha256.cu compress_pad64: 64 rounds, each given K[i] + W[i]
    whole, then the feed-forward."""
    a, b, c, d, e, f, g, h = state
    r = S2._rotr
    for x in kw:
        t1 = (h + (r(e, 6) ^ r(e, 11) ^ r(e, 25))
              + ((e & f) ^ ((e ^ S2.M32) & g)) + x)
        t2 = (r(a, 2) ^ r(a, 13) ^ r(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
        a, b, c, d, e, f, g, h = ((t1 + t2) & S2.M32, a, b, c,
                                  (d + t1) & S2.M32, e, f, g)
    return [(s + v) & S2.M32 for s, v in zip(state, (a, b, c, d, e, f, g,
                                                     h))]


def test_sha256_kernel_merge_model_matches_hashlib_and_plain():
    """The kernels' Sha256Merge: one compression of left || right from the
    IV, then the pad block through the source's constant table, equals
    hashlib's SHA-256 of the 64 bytes and the plain merge, pair by pair."""
    kw = _pad_kw_of_source()
    assert len(kw) == 64
    words = _leaves(64, 31)
    plain = K.sha256_merge_plain(torch.from_numpy(words.astype(np.int64)))
    for j in range(32):
        msg = [int(v) for v in words[:, 2 * j]] + \
            [int(v) for v in words[:, 2 * j + 1]]
        got = _rounds_kw(S2.compress(list(S2.IV), msg), kw)
        data = b"".join(v.to_bytes(4, "big") for v in msg)
        exp = [int.from_bytes(hashlib.sha256(data).digest()[4 * i:4 * i + 4],
                              "big") for i in range(8)]
        assert got == exp == plain[:, j].tolist(), j


@pytest.mark.parametrize("hash_fn", list(HASHES))
def test_paths_from_buffer_views_equal_separate_levels(hash_fn):
    h = get_hasher(hash_fn)
    leaves = torch.from_numpy(_leaves(256, 9).astype(np.int64))
    tree = M.MerkleTree.from_leaves(h, leaves)
    base = tree.levels[1]._base
    assert base is not None and all(lvl._base is base
                                    for lvl in tree.levels[1:])
    sep = M.MerkleTree(h, [lvl.clone() for lvl in
                           _per_level(h.merge_pairs, leaves)])
    assert all(torch.equal(a, b) for a, b in zip(tree.levels, sep.levels))
    assert tree.root() == sep.root()
    idx = [[0, 1, 77, 255], [3, 3, 128]]
    assert M.prove_batch_multi([tree, tree], idx) == \
        M.prove_batch_multi([sep, sep], idx)
    paths = M.prove_batch_multi([tree], [[77]])[0]
    leaf = h.to_host(leaves[:, 77:78])[0]
    assert M.verify_path(h, tree.root(), 77, leaf, paths[77])


class _PerLevelBlake3(Blake3Hasher):
    """BLAKE3 with one merge a level and separate level tensors, as the
    port built its trees before the tree kernels."""
    merge_tree = None


def test_checkpoint_of_separate_levels_resumes(tmp_path):
    opts = ProofOptions(num_queries=8, blowup=4, hash_fn="blake3")
    ex = RC.RescueChainExample(16, opts, device="cpu")
    old = Prover(ex.air(), device="cpu", hasher=_PerLevelBlake3())
    ref = old.prove(ex.trace, checkpoint=old.checkpointer(
        str(tmp_path))).to_bytes()
    assert ref == Prover(ex.air(), device="cpu").prove(ex.trace).to_bytes()
    fresh = Prover(ex.air(), device="cpu")
    assert fresh.prove(torch.zeros_like(ex.trace), checkpoint=fresh
                       .checkpointer(str(tmp_path))).to_bytes() == ref
