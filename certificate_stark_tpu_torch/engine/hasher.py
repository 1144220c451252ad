"""Commitment hasher: Rescue63 digests truncated to 4 elements.

Counterpart of `RescueHasher` in certificate_stark_tpu/engine/hasher.py
(the ProofOptions default). Device side: digests are int64 columns [4, B]
(Montgomery). Host side: Python ints in standard form, for the coin.
"""
from __future__ import annotations

from ..ops import field as F, rescue as R
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

    # -- host --------------------------------------------------------------
    def host_digest(self, elements) -> tuple:
        return tuple(
            RR.digest([int(e) % F.P for e in elements])[:R.TRUNC_DIGEST])

    def host_merge(self, d0, d1) -> tuple:
        return tuple(RR.merge4(list(d0), list(d1)))


def get_hasher(name: str):
    if name != "rescue":
        raise NotImplementedError(
            f"hash_fn={name!r}: the port commits with Rescue only")
    return RescueHasher()
