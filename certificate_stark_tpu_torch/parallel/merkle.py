"""A Merkle tree whose leaves are split over the ranks of a Mesh.

Rank r holds the leaves [r*m, (r+1)*m) of the tree's D*m leaves and builds
their subtree on its device (engine/merkle.py `tree_levels`: one tree
kernel launch for BLAKE3, SHA-256 and SHA3, a merge launch a level for
Rescue). One all-gather brings the D subtree roots to every rank, which
merges the top log2 D levels itself. D and m are powers of two and the
blocks aligned, so the root is the single-device tree's root. A path is the
owner's path inside its subtree followed by the top levels' path of the
owner's root.
"""
from __future__ import annotations

import torch

from ..engine import merkle as M


class ShardedTree:
    def __init__(self, mesh, hasher, leaves):
        """leaves [digest_len, m]: this rank's block of the leaves."""
        m = leaves.shape[-1]
        assert m & (m - 1) == 0 and mesh.size & (mesh.size - 1) == 0
        self.mesh, self.hasher, self.m = mesh, hasher, m
        self.local = M.MerkleTree.from_leaves(hasher, leaves)
        roots = mesh.all_gather(self.local.levels[-1][:, 0])   # [D, dl]
        self.top = M.MerkleTree.from_leaves(hasher, roots.T.contiguous())

    @property
    def levels(self):
        """This rank's subtree levels, leaves first."""
        return self.local.levels

    def root(self) -> tuple:
        return self.top.root()

    def paths(self, indices) -> dict:
        """{index: path} for the leaf indices (the same list on every
        rank; a collective)."""
        uniq = sorted({int(i) for i in indices})
        if not uniq:
            return {}
        dev = self.local.levels[0].device
        idx = torch.tensor(uniq, dtype=torch.int64, device=dev)
        owner = idx // self.m
        cur = idx % self.m
        sibs = []
        for lvl in self.local.levels[:-1]:
            sibs.append(lvl.index_select(1, cur ^ 1))
            cur = cur >> 1
        q, depth = len(uniq), len(sibs)
        own = {}
        if depth:
            # [dl, depth, Q] from each rank, the owner's column kept
            got = self.mesh.gather_owned(torch.stack(sibs, dim=1), owner)
            flat = self.hasher.to_host(got.reshape(got.shape[0], depth * q))
            own = {i: [flat[li * q + qi] for li in range(depth)]
                   for qi, i in enumerate(uniq)}
        owners = sorted({i // self.m for i in uniq})
        top = M.prove_batch_multi([self.top], [owners])[0] \
            if self.top.depth else {o: [] for o in owners}
        return {i: own.get(i, []) + top[i // self.m] for i in uniq}
