"""Commitment hashers.

Counterpart of certificate_stark_tpu/engine/hasher.py `RescueHasher` (the
ProofOptions default) and `Blake3Hasher` (bench.py's). Device side: digests
are int64 columns [digest_len, B]. Host side: Python ints, for the coin.

  rescue  Rescue63 digests truncated to 4 elements (Montgomery on the
          device, standard form on the host).
  blake3  BLAKE3-256 digests as 8 u32 LE words; a leaf is the hash of its
          row's elements as 8-byte LE standard form, a merge the hash of the
          64 bytes left || right (the JAX package's `merge_pairs`, not
          BLAKE3's PARENT node). The device side is csrc/blake3.cu.
"""
from __future__ import annotations

from ..ops import blake3 as B3, field as F, kernels as K, rescue as R
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


class Blake3Hasher:
    name = "blake3"
    digest_len = 8  # u32 words

    # -- device ------------------------------------------------------------
    def hash_columns(self, cols):
        """cols: [k, B] Montgomery -> [8, B] digest words."""
        if K.use_plain(cols):
            return K.blake3_leaves_plain(cols)
        return K.blake3_leaves(cols.contiguous())

    def merge_pairs(self, level):
        """level: [8, 2m] -> [8, m] by hashing adjacent pairs."""
        if K.use_plain(level):
            return K.blake3_merge_plain(level)
        return K.blake3_merge(level.contiguous())

    @staticmethod
    def to_host(cols) -> list:
        """[8, m] digest words -> m tuples of ints."""
        return [tuple(d) for d in cols.cpu().T.tolist()]

    # -- host --------------------------------------------------------------
    def host_digest(self, elements) -> tuple:
        return B3.digest_words(b"".join(
            (int(e) % F.P).to_bytes(8, "little") for e in elements))

    def host_merge(self, d0, d1) -> tuple:
        return B3.digest_words(b"".join(
            int(w).to_bytes(4, "little") for w in tuple(d0) + tuple(d1)))


HASHERS = {"rescue": RescueHasher, "blake3": Blake3Hasher}


def get_hasher(name: str):
    if name not in HASHERS:
        raise NotImplementedError(
            f"hash_fn={name!r}: the port commits with {sorted(HASHERS)}")
    return HASHERS[name]()
