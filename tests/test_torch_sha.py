"""The port's SHA-256 and SHA3-256 commitment paths against hashlib and the
JAX package, on the CPU: the plain versions of the csrc/sha256.cu and
csrc/sha3.cu kernels (leaf hashes of Montgomery rows of k = 1, 4, 12, 17,
94 elements and ragged batches, merges), the padding at block and rate
boundaries, the 64-bit rotations of the plain Keccak, the host hashers and
coins of `Sha256Hasher` and `Sha3Hasher`. Oracles: hashlib, JAX's
`sha3_words(..., xp=np)`, `keccak_f(..., xp=np)` and `sha256_words`
(jitted once a shape), and the JAX hashers. Inputs are seeded numpy
arrays fed to both packages. Tolerance: exact equality."""
import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine.coin import RandomCoin as JCoin
from certificate_stark_tpu.ops import blake3 as JB
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.ops import sha256 as JS
from certificate_stark_tpu.ops import sha3 as JS3
from certificate_stark_tpu_torch.engine import merkle as M
from certificate_stark_tpu_torch.engine.coin import RandomCoin
from certificate_stark_tpu_torch.engine.hasher import (Sha256Hasher,
                                                       Sha3Hasher, get_hasher)
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops import sha256 as S2
from certificate_stark_tpu_torch.ops import sha3 as S3
from certificate_stark_tpu_torch.utils.convert import from_jax_limbs

P = JF.P
KS = [1, 4, 12, 17, 94]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _felts(k, b, seed):
    """[4, k, b] JAX Montgomery limbs of seeded random elements, the top
    and bottom of the field among them."""
    vals = np.random.default_rng(seed).integers(0, P, size=(k, b),
                                                dtype=np.uint64)
    vals[0, 0], vals[-1, -1] = P - 1, 0
    return JF.from_int(vals)


def _row_bytes(std, j):
    return b"".join(int(v).to_bytes(8, "little") for v in std[:, j])


@pytest.mark.parametrize("k", KS)
def test_sha256_leaves_match_hashlib_and_jax(k):
    limbs = _felts(k, 37, k)
    std = JF.to_int(limbs)                              # [k, 37] ints
    got = K.sha256_leaves_plain(from_jax_limbs(limbs))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(K.sha256_leaves(from_jax_limbs(limbs)), got)
    for j in (0, 1, 36):
        assert tuple(got[:, j].tolist()) == S2.digest_words(_row_bytes(std, j))
    exp = jax.jit(JH.Sha256Hasher().hash_columns)(jnp.asarray(limbs))
    assert np.array_equal(got.numpy(), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("k", KS)
def test_sha3_leaves_match_hashlib_and_jax_numpy_path(k):
    limbs = _felts(k, 37, 100 + k)
    std = JF.to_int(limbs)
    std_limbs = JF.from_int(std, mont=False)
    exp = JS3.sha3_words(JB.felems_to_words_le(std_limbs, xp=np), xp=np)
    got = K.sha3_leaves_plain(from_jax_limbs(limbs))
    assert np.array_equal(got.numpy(), exp.astype(np.int64))
    assert torch.equal(K.sha3_leaves(from_jax_limbs(limbs)), got)
    for j in (0, 1, 36):
        assert tuple(got[:, j].tolist()) == S3.digest_words(_row_bytes(std, j))


@pytest.mark.parametrize("b", [1, 2, 5, 129])
def test_leaves_of_ragged_batches(b):
    """Batches of any width: every column hashes on its own."""
    limbs = _felts(12, b, b)
    std = JF.to_int(limbs)
    x = from_jax_limbs(limbs)
    sha2, sha3 = K.sha256_leaves_plain(x), K.sha3_leaves_plain(x)
    assert sha2.shape == sha3.shape == (8, b)
    for j in {0, b // 2, b - 1}:
        data = _row_bytes(std, j)
        assert tuple(sha2[:, j].tolist()) == S2.digest_words(data)
        assert tuple(sha3[:, j].tolist()) == S3.digest_words(data)


def test_felems_to_words_matches_jax():
    limbs = _felts(5, 9, 3)
    std_limbs = JF.from_int(JF.to_int(limbs), mont=False)
    exp = np.asarray(JS.felems_to_words(jnp.asarray(std_limbs)))
    std = K._std_plain(from_jax_limbs(limbs))
    assert np.array_equal(S2.felems_to_words(std).numpy(),
                          exp.astype(np.int64))


@pytest.mark.parametrize("m", [1, 2, 33])
def test_merges_match_jax(m):
    level = np.random.default_rng(m).integers(0, 1 << 32, size=(8, 2 * m),
                                              dtype=np.uint64)
    lvl = torch.from_numpy(level.astype(np.int64))
    both = np.concatenate([level[:, 0::2], level[:, 1::2]]).astype(np.uint32)
    exp3 = JS3.sha3_words(both, xp=np)
    assert np.array_equal(K.sha3_merge_plain(lvl).numpy(),
                          exp3.astype(np.int64))
    exp2 = np.asarray(jax.jit(JS.sha256_words)(jnp.asarray(both)))
    assert np.array_equal(K.sha256_merge_plain(lvl).numpy(),
                          exp2.astype(np.int64))
    assert torch.equal(K.sha3_merge(lvl), K.sha3_merge_plain(lvl))
    assert torch.equal(K.sha256_merge(lvl), K.sha256_merge_plain(lvl))
    for h in (Sha256Hasher(), Sha3Hasher()):
        got = h.merge_pairs(lvl)
        for j in (0, m - 1):
            assert tuple(got[:, j].tolist()) == h.host_merge(
                tuple(level[:, 2 * j]), tuple(level[:, 2 * j + 1]))


@pytest.mark.parametrize("n", [13, 14, 15, 16, 29, 30, 33, 34, 35, 67, 68,
                               69, 188])
def test_block_and_rate_boundaries(n):
    """Messages of n words around SHA-256's 16-word blocks (the pad needs 3
    words) and SHA3-256's 34-word rate (34j words take a whole pad block),
    against hashlib."""
    w = np.random.default_rng(n).integers(0, 1 << 32, size=(n, 3),
                                          dtype=np.uint64).astype(np.int64)
    t = torch.from_numpy(w)
    got2, got3 = S2.sha256_words(t), S3.sha3_words(t)
    assert got2.shape[0] == 8 and S2.n_blocks(n) == (4 * n + 9 + 63) // 64
    assert S3.n_blocks(n) == (4 * n) // 136 + 1
    for j in range(3):
        be = b"".join(int(x).to_bytes(4, "big") for x in w[:, j])
        le = b"".join(int(x).to_bytes(4, "little") for x in w[:, j])
        assert tuple(got2[:, j].tolist()) == S2.digest_words(be)
        assert tuple(got3[:, j].tolist()) == S3.digest_words(le)
    # the JAX package's SHA3 on the same words
    exp = JS3.sha3_words(w.astype(np.uint32), xp=np)
    assert np.array_equal(got3.numpy(), exp.astype(np.int64))


def test_rotations_of_lanes_with_the_top_bit_set():
    """rotl64 on (lo, hi) halves, every amount 0 .. 63, against Python
    ints, on lanes with bit 63, bit 31 or both set."""
    lanes = [1 << 63, (1 << 63) | 1, 0x80000000, 0xFFFFFFFFFFFFFFFF,
             0x8000000080000000, 0x0123456789ABCDEF]
    mask = (1 << 64) - 1
    lo = torch.tensor([v & 0xFFFFFFFF for v in lanes], dtype=torch.int64)
    hi = torch.tensor([v >> 32 for v in lanes], dtype=torch.int64)
    for r in range(64):
        rlo, rhi = S3.rotl64(lo, hi, r)
        got = [(h << 32) | lw for lw, h in zip(rlo.tolist(), rhi.tolist())]
        assert got == [((v << r) | (v >> (64 - r))) & mask for v in lanes], r


def test_keccak_f_matches_jax_numpy_path():
    """One permutation of states whose lanes have the top bits set, against
    the JAX package's keccak_f on numpy."""
    rng = np.random.default_rng(21)
    st = rng.integers(0, 1 << 32, size=(25, 2, 4), dtype=np.uint64)
    st[:, :, 0] = 0xFFFFFFFF
    st[:, 1, 1] |= 0x80000000
    jst = JS3.keccak_f([(st[i, 0].astype(np.uint32), st[i, 1].astype(np.uint32))
                        for i in range(25)], xp=np)
    got = S3.keccak_f([(torch.from_numpy(st[i, 0].astype(np.int64)),
                        torch.from_numpy(st[i, 1].astype(np.int64)))
                       for i in range(25)])
    for (glo, ghi), (jlo, jhi) in zip(got, jst):
        assert np.array_equal(glo.numpy(), jlo.astype(np.int64))
        assert np.array_equal(ghi.numpy(), jhi.astype(np.int64))


@pytest.mark.parametrize("name", ["sha256", "sha3"])
def test_host_hashers_match_jax(name):
    h, jh = get_hasher(name), JH.get_hasher(name)
    assert h.name == jh.name == name and h.digest_len == jh.digest_len == 8
    rng = np.random.default_rng(5)
    for size in (0, 1, 16, 17, 94, 200):
        elems = [int(v) for v in rng.integers(0, P, size=size,
                                              dtype=np.uint64)]
        assert h.host_digest(elems) == jh.host_digest(elems)
    d0, d1 = h.host_digest([1, 2, 3]), h.host_digest([P - 1])
    assert h.host_merge(d0, d1) == jh.host_merge(d0, d1)
    # a device leaf and a host digest of the same row agree
    limbs = _felts(7, 3, 9)
    leaf = h.to_host(h.hash_columns(from_jax_limbs(limbs)))[2]
    assert leaf == h.host_digest(JF.to_int(limbs)[:, 2])


@pytest.mark.parametrize("name", ["sha256", "sha3"])
def test_merkle_paths_verify_on_both_hashers(name):
    from certificate_stark_tpu.engine import merkle as JM
    h, jh = get_hasher(name), JH.get_hasher(name)
    tree = M.MerkleTree.from_leaves(h, h.hash_columns(from_jax_limbs(
        _felts(4, 32, 31))))
    idx = [0, 5, 31]
    paths = M.prove_batch_multi([tree], [idx])[0]
    for i in idx:
        leaf = h.to_host(tree.levels[0][:, i:i + 1])[0]
        assert M.verify_path(h, tree.root(), i, leaf, paths[i])
        assert JM.verify_path(jh, tree.root(), i, leaf, paths[i])


@pytest.mark.parametrize("name", ["sha256", "sha3"])
def test_coin_journal_matches_jax(name):
    journal, jjournal = [], []
    coin = RandomCoin(get_hasher(name), [9, 8, 7, 6], journal=journal)
    jcoin = JCoin(JH.get_hasher(name), [9, 8, 7, 6], journal=jjournal)
    for c in (coin, jcoin):
        c.reseed(tuple(range(8)))
        c.draw_felts(5)
        c.draw_indices(30, 64)          # repeats are rejected
        c.reseed(c.h.host_digest([1, 2, 3]))
        c.draw_felt()
    assert journal == jjournal
    for bits in (0, 3, 6):
        assert coin.grind(bits) == jcoin.grind(bits)


def test_unknown_hasher_raises():
    with pytest.raises(ValueError, match="choices"):
        get_hasher("md5")


def test_wrappers_refuse_other_devices():
    """On a tensor that is neither on the CPU nor on a CUDA device the
    wrappers raise; they never fall back."""
    x = torch.zeros((4, 8), dtype=torch.int64, device="meta")
    for fn in (K.sha256_leaves, K.sha3_leaves, K.sha256_merge,
               K.sha3_merge):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x)
