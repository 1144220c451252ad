"""Merkle commitment trees built on the device, opened and checked on the host.

Counterpart of certificate_stark_tpu/engine/merkle.py and `tree_levels` of
certificate_stark_tpu/engine/kernels.py. Leaves are digest columns
[digest_len, n] from a hasher. A hasher with `merge_tree` (BLAKE3,
SHA-256, SHA3) builds every level in one call, as views of one [8, n - 1]
buffer; Rescue merges level by level. A tree's levels may be either form,
or separate tensors read back from a checkpoint.
"""
from __future__ import annotations

import torch


def tree_levels(hasher, leaves):
    """All Merkle levels, leaves first, root ([digest_len, 1]) last."""
    merge_tree = getattr(hasher, "merge_tree", None)
    if merge_tree is not None:
        return merge_tree(leaves)
    levels = [leaves]
    while levels[-1].shape[-1] > 1:
        levels.append(hasher.merge_pairs(levels[-1]))
    return levels


class MerkleTree:
    def __init__(self, hasher, levels):
        n = levels[0].shape[-1]
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        self.hasher = hasher
        self.levels = list(levels)
        self._root = None

    @classmethod
    def from_leaves(cls, hasher, leaves):
        return cls(hasher, tree_levels(hasher, leaves))

    @property
    def depth(self):
        return len(self.levels) - 1

    def root(self) -> tuple:
        if self._root is None:
            self._root = self.hasher.to_host(self.levels[-1][:, :1])[0]
        return self._root


def prove_batch_multi(trees, indices_list):
    """Authentication paths (sibling digests bottom-up) for several trees,
    with one gather per level and one transfer. Returns one {index: path}
    dict per tree."""
    assert len(trees) == len(indices_list)
    out = []
    for tree, indices in zip(trees, indices_list):
        uniq = sorted({int(i) for i in indices})
        if not uniq:
            out.append({})
            continue
        dev = tree.levels[0].device
        cur = torch.tensor(uniq, dtype=torch.int64, device=dev)
        sibs = []
        for lvl in tree.levels[:-1]:
            sibs.append(lvl.index_select(1, cur ^ 1))
            cur = cur >> 1
        # level-major, then index
        flat = tree.hasher.to_host(torch.cat(sibs, dim=1))
        q = len(uniq)
        out.append({i: [flat[li * q + qi] for li in range(tree.depth)]
                    for qi, i in enumerate(uniq)})
    return out


def verify_path(hasher, root: tuple, index: int, leaf: tuple,
                path: list) -> bool:
    """Host-side path check."""
    cur = tuple(leaf)
    i = index
    for sib in path:
        cur = hasher.host_merge(sib, cur) if i & 1 \
            else hasher.host_merge(cur, sib)
        i >>= 1
    return tuple(cur) == tuple(root)
