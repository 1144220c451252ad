"""Updatable Rescue63 Merkle tree for witness generation (a copy of
certificate_stark_tpu/utils/account_tree.py, in Python ints only).

Mirrors the winterfell fork's `MerkleTree::<Rescue63>` API as used by
TransactionMetadata::build_random (reference src/lib.rs:261-420):
build_empty(depth), update_leaf(idx, digest), prove(idx) -> [leaf, siblings...],
root(). Sparse storage over per-level "empty subtree" defaults, so building an
empty depth-d tree costs d merges.
"""
from __future__ import annotations

from . import rescue_ref as RR

ZERO_DIGEST = (0,) * 7

def _merge(d0, d1):
    return tuple(RR.merge(list(d0), list(d1)))


def leaf_hash(values14) -> tuple:
    """Account leaf digest: merge(H(v0..6), H(v7..13)) = perm(v0..13)[0..7]
    (reference src/lib.rs:287-292; equals one permutation of the 14 values)."""
    vals = [int(v) % RR.P for v in values14]
    return _merge(vals[:7], vals[7:])


class AccountTree:
    def __init__(self, depth: int):
        self.depth = depth
        # empty[l] = digest of an empty subtree of height l (empty[0] = zero leaf)
        self.empty = [ZERO_DIGEST]
        for _ in range(depth):
            self.empty.append(_merge(self.empty[-1], self.empty[-1]))
        self.nodes = {}  # (level, index) -> digest; level 0 = leaves

    def _get(self, level, idx):
        return self.nodes.get((level, idx), self.empty[level])

    def update_leaf(self, idx: int, digest):
        self.nodes[(0, idx)] = tuple(digest)
        for lvl in range(self.depth):
            pair_base = idx & ~1
            left = self._get(lvl, pair_base)
            right = self._get(lvl, pair_base + 1)
            idx >>= 1
            self.nodes[(lvl + 1, idx)] = _merge(left, right)

    def prove(self, idx: int) -> list:
        """[leaf, sibling_0, ..., sibling_{depth-1}] digests (winterfell order)."""
        out = [self._get(0, idx)]
        for lvl in range(self.depth):
            out.append(self._get(lvl, idx ^ 1))
            idx >>= 1
        return out

    def root(self) -> tuple:
        return self._get(self.depth, 0)


def verify_path(root, idx, path, depth) -> bool:
    cur = tuple(path[0])
    for lvl in range(depth):
        sib = path[1 + lvl]
        bit = (idx >> lvl) & 1
        cur = _merge(sib, cur) if bit else _merge(cur, sib)
    return cur == tuple(root)
