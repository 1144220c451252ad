"""Commitment hashers.

Counterpart of certificate_stark_tpu/engine/hasher.py: `RescueHasher` (the
ProofOptions default), `Blake3Hasher` (bench.py's and the example CLI's),
`Sha256Hasher` and `Sha3Hasher`. Device side: digests are int64 columns
[digest_len, B]. Host side: Python ints, for the coin.

  rescue  Rescue63 digests truncated to 4 elements (Montgomery on the
          device, standard form on the host).
  blake3  BLAKE3-256 digests as 8 u32 LE words; a leaf is the hash of its
          row's elements as 8-byte LE standard form, a merge the hash of the
          64 bytes left || right (the JAX package's `merge_pairs`, not
          BLAKE3's PARENT node). The device side is csrc/blake3.cu.
  sha256  SHA-256 digests as 8 u32 BE words (the SHA spec's words); a leaf
          is the hash of its row's 8-byte LE standard-form elements, a merge
          the hash of the 64 bytes of left || right as BE words. The device
          side is csrc/sha256.cu.
  sha3    SHA3-256 digests as 8 u32 LE words, leaves and merges as for
          BLAKE3. The device side is csrc/sha3.cu.

The three byte hashers build a whole Merkle tree in one kernel launch
(`merge_tree`); Rescue merges a level at a time (engine/merkle.py).
"""
from __future__ import annotations

from ..ops import blake3 as B3, field as F, kernels as K, rescue as R
from ..ops import sha256 as S2, sha3 as S3
from ..utils import rescue_ref as RR


class RescueHasher:
    name = "rescue"
    digest_len = R.TRUNC_DIGEST

    # -- device ------------------------------------------------------------
    def hash_columns(self, cols):
        """cols: [k, B] -> [4, B] truncated digests."""
        return R.digest(cols)[:R.TRUNC_DIGEST]

    def merge_pairs(self, level):
        """level: [4, 2m] -> [4, m] by merging adjacent pairs."""
        return R.merge4(level[:, 0::2], level[:, 1::2])

    @staticmethod
    def to_host(cols) -> list:
        """[4, m] Montgomery digests -> m tuples of standard-form ints."""
        return [tuple(d) for d in F.from_mont(cols).cpu().T.tolist()]

    # -- host --------------------------------------------------------------
    def host_digest(self, elements) -> tuple:
        return tuple(
            RR.digest([int(e) % F.P for e in elements])[:R.TRUNC_DIGEST])

    def host_merge(self, d0, d1) -> tuple:
        return tuple(RR.merge4(list(d0), list(d1)))


class _ByteHasher:
    """A hasher of bytes: digests of 8 u32 words, whose byte order is the
    hash's (`_order`). The device side runs the leaf, merge and tree
    kernels (`_leaves`, `_merge`, `_tree`) or their plain versions."""
    digest_len = 8  # u32 words

    # -- device ------------------------------------------------------------
    def hash_columns(self, cols):
        """cols: [k, B] Montgomery -> [8, B] digest words."""
        if K.use_plain(cols):
            return self._leaves_plain(cols)
        return self._leaves(cols.contiguous())

    def merge_pairs(self, level):
        """level: [8, 2m] -> [8, m] by hashing adjacent pairs."""
        if K.use_plain(level):
            return self._merge_plain(level)
        return self._merge(level.contiguous())

    def merge_tree(self, leaves):
        """leaves [8, n] -> every Merkle level, leaves first, root last; the
        levels above the leaves are views of one [8, n - 1] buffer."""
        if K.use_plain(leaves):
            buf = K.tree_plain(self._merge_plain, leaves)
        else:
            buf = self._tree(leaves.contiguous())
        return [leaves] + K.tree_levels_of(buf)

    @staticmethod
    def to_host(cols) -> list:
        """[8, m] digest words -> m tuples of ints."""
        return [tuple(d) for d in cols.cpu().T.tolist()]

    # -- host --------------------------------------------------------------
    def host_digest(self, elements) -> tuple:
        return self._bytes(b"".join(
            (int(e) % F.P).to_bytes(8, "little") for e in elements))

    def host_merge(self, d0, d1) -> tuple:
        return self._bytes(b"".join(
            int(w).to_bytes(4, self._order) for w in tuple(d0) + tuple(d1)))


class Blake3Hasher(_ByteHasher):
    name = "blake3"
    _order = "little"
    _leaves = staticmethod(K.blake3_leaves)
    _merge = staticmethod(K.blake3_merge)
    _tree = staticmethod(K.blake3_tree)
    _leaves_plain = staticmethod(K.blake3_leaves_plain)
    _merge_plain = staticmethod(K.blake3_merge_plain)
    _bytes = staticmethod(B3.digest_words)


class Sha256Hasher(_ByteHasher):
    name = "sha256"
    _order = "big"
    _leaves = staticmethod(K.sha256_leaves)
    _merge = staticmethod(K.sha256_merge)
    _tree = staticmethod(K.sha256_tree)
    _leaves_plain = staticmethod(K.sha256_leaves_plain)
    _merge_plain = staticmethod(K.sha256_merge_plain)
    _bytes = staticmethod(S2.digest_words)


class Sha3Hasher(_ByteHasher):
    name = "sha3"
    _order = "little"
    _leaves = staticmethod(K.sha3_leaves)
    _merge = staticmethod(K.sha3_merge)
    _tree = staticmethod(K.sha3_tree)
    _leaves_plain = staticmethod(K.sha3_leaves_plain)
    _merge_plain = staticmethod(K.sha3_merge_plain)
    _bytes = staticmethod(S3.digest_words)


HASHERS = {"rescue": RescueHasher, "sha256": Sha256Hasher,
           "blake3": Blake3Hasher, "sha3": Sha3Hasher}


def get_hasher(name: str):
    if name not in HASHERS:
        raise ValueError(f"hash_fn={name!r}: choices {sorted(HASHERS)}")
    return HASHERS[name]()
