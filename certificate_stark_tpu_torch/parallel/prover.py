"""The STARK prover sharded over the ranks of a Mesh.

Counterpart of certificate_stark_tpu/parallel/prover.py (`ShardedProver`,
`prove_sharded`, :37-173). Every rank runs the whole protocol with the same
coin; every big-domain tensor is block-sharded over its last axis, rank r
of D holding the points [r*m/D, (r+1)*m/D) of an m-point axis:

  * trace iNTT: the six-step transform of parallel/ntt.py (where n does
    not split over D, every rank runs the local one on the gathered blocks
    and keeps its block);
  * LDE by coset decomposition: lde[j + b*i] = NTT_n(c_k (o w_bn^j)^k)[i],
    b batched size-n transforms whose output block i of rank r is its own
    block of the bn points, with no further exchange (this replaces the
    zero-padded LDE of engine/prover.py for this prover only);
  * the domain tables (points, zerofiers, boundary divisors, x^adj) built
    for the rank's block only (engine/prover.py `_domain`), the periodic
    columns read at the block's offset;
  * constraint evaluation in the single-device prover's segments on the
    block, the next-row frame's last b points from rank r+1 (one small
    all-gather of every rank's first b columns);
  * composition: the inverse transform over bn, o^-i with the global i,
    and one all-to-all with uneven splits from blocks of bn/D coefficients
    to the blocks of kn/D the column split H_c(x) needs; then its LDE as
    the trace's;
  * OOD: each rank's ood launch on its coefficient block, from the power
    z^(r n/D), the partials gathered and added in the field;
  * DEEP: pointwise on the block;
  * Merkle commits: parallel/merkle.py ShardedTree (subtrees of the
    blocks, the top log2 D levels on every rank);
  * FRI: per layer one all-to-all regroups the values so that each rank
    holds the `fold` values of its block of leaves, which it commits and
    folds; a layer of fewer than D leaves is gathered and the rest runs
    replicated;
  * grinding on rank 0, its nonce broadcast; query openings gathered from
    the ranks that hold them.

The proof is the single-device proof, byte for byte, on every rank.
Checkpoints are not ported for this prover.
"""
from __future__ import annotations

import torch

from ..engine import fri as FRI
from ..engine import merkle as M
from ..engine.prover import Prover
from ..ops import field as F, kernels as K, ntt as NTT
from . import ntt as PNTT
from .merkle import ShardedTree
from .mesh import make_mesh


def _overlap(a0, a1, b0, b1):
    return max(0, min(a1, b1) - max(a0, b0))


class ShardedProver(Prover):
    """A Prover whose device phases run on this rank's block of the
    domain; `prove(trace)` takes the whole trace [w, n] on every rank and
    returns the same Proof on every rank."""

    def __init__(self, air, mesh=None, hasher=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.D, self.rank = self.mesh.size, self.mesh.rank
        n, D = air.trace_length, self.D
        if D & (D - 1) or n % D:
            raise ValueError(f"{D} ranks: a power of two that divides the "
                             f"trace length {n}")
        self._coset = None
        self._halo = None
        super().__init__(air, self.mesh.device, hasher)

    def _domain(self):
        return self._block(self.bn)

    def _block(self, length: int):
        """This rank's [lo, hi) of a length-point axis."""
        q = length // self.D
        return self.rank * q, (self.rank + 1) * q

    def _gather(self, x):
        """The block x [*B, L/D] of every rank -> the whole [*B, L]."""
        g = self.mesh.all_gather(x)                        # [D, *B, L/D]
        return g.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,))

    def _transform(self, x, length: int, inverse: bool = False):
        """The NTT of `length` over the last axis of the distributed array
        whose block x holds -> this rank's block of the transform; where
        length does not split over the ranks, on the gathered whole."""
        if PNTT.splits(length, self.D):
            return PNTT.ntt_sharded(self.mesh, x, length, inverse)
        lo, hi = self._block(length)
        return NTT.ntt(self._gather(x), inverse)[..., lo:hi]

    # -- trace and LDE --------------------------------------------------------
    def phase_trace(self, trace):
        """trace [w, n] (whole) -> (this rank's coefficient block
        [w, n/D], its LDE block [w, bn/D])."""
        lo, hi = self._block(self.n)
        coeffs = self._transform(trace[:, lo:hi], self.n, inverse=True)
        return coeffs, self._lde_from_coeffs(coeffs)

    def _coset_table(self):
        """[b, n/D]: (offset * w_bn^j)^k for j < b and the k of this
        rank's coefficient block."""
        if self._coset is None:
            lo, hi = self._block(self.n)
            rows = []
            for j in range(self.b):
                base = self.offset * pow(self.gen_big, j, F.P) % F.P
                rows.append(F.mul(F.powers(base, hi - lo, self.device),
                                  F.const(pow(base, lo, F.P), self.device)))
            self._coset = torch.stack(rows)
        return self._coset

    def _lde_from_coeffs(self, coeffs):
        """Coefficient block [*B, n/D] -> LDE block [*B, bn/D]: b size-n
        transforms of the coset-scaled coefficients; point j + b*i is
        evaluation i of transform j, and this rank's block of i is its
        block of points."""
        lead = tuple(coeffs.shape[:-1])
        scaled = F.mul(coeffs[..., None, :], self._coset_table())
        evals = self._transform(scaled, self.n)            # [*B, b, n/D]
        return evals.transpose(-1, -2).reshape(lead + (self.j_hi
                                                       - self.j_lo,))

    # -- composition ------------------------------------------------------------
    def phase_composition(self, lde, t_alpha, t_beta, b_alpha, b_beta):
        """As Prover.phase_composition on this rank's block ->
        (h_coeffs [d, k, n/D], h_lde [d, k, bn/D])."""
        heads = self.mesh.all_gather(lde[:, :self.b])      # [D, w, b]
        self._halo = heads[(self.rank + 1) % self.D]
        try:
            return super().phase_composition(lde, t_alpha, t_beta, b_alpha,
                                             b_beta)
        finally:
            self._halo = None

    def _frame(self, lde, j0, j1):
        """The block's rows at [j0, j1) and at j + b, the points past the
        block's end from the next rank's first b columns."""
        m, lo, hi = lde.shape[-1], j0 + self.b, j1 + self.b
        parts = []
        if lo < m:
            parts.append(lde[:, lo:min(hi, m)])
        if hi > m:
            parts.append(self._halo[:, max(lo, m) - m:hi - m])
        return lde[:, j0:j1], torch.cat(parts, dim=1)

    def _split_composition(self, comp):
        """H's values, block [d, bn/D] -> the column polynomials'
        coefficients, block [d, k, n/D]."""
        D, s, d, k = self.D, self.rank, self.d, self.k
        m, q = self.bn // D, k * self.n // D
        o_inv = pow(self.offset, F.P - 2, F.P)
        coeffs = F.mul(self._transform(comp, self.bn, inverse=True),
                       F.mul(F.powers(o_inv, m, self.device),
                             F.const(pow(o_inv, self.j_lo, F.P),
                                     self.device)))
        # coefficient blocks of m -> blocks of q = kn/D (those below kn)
        send = [_overlap(s * m, (s + 1) * m, r * q, (r + 1) * q)
                for r in range(D)]
        recv = [_overlap(t * m, (t + 1) * m, s * q, (s + 1) * q)
                for t in range(D)]
        got = self.mesh.all_to_all(coeffs[:, :sum(send)].T, send, recv)
        return got.T.reshape(d, self.n // D, k).transpose(1, 2).contiguous()

    # -- OOD ------------------------------------------------------------------
    def _ood_start(self):
        """The power r*n/D of the OOD points that meets this rank's first
        coefficient."""
        return self.rank * (self.n // self.D)

    def _ood_sum(self, *parts):
        """Every rank's partial sums, gathered and added in the field."""
        got = self.mesh.all_gather(torch.cat(parts, dim=1))    # [D, d, ...]
        total = got[0]
        for part in got[1:]:
            total = F.add(total, part)
        return torch.split(total, [p.shape[1] for p in parts], dim=1)

    # -- commitments, FRI, grinding, openings ------------------------------------
    def commit(self, rows):
        """This rank's block of rows [r, m] -> a ShardedTree."""
        return ShardedTree(self.mesh, self.hasher,
                           self.hasher.hash_columns(rows))

    def _fri_group(self, cur, size: int, fold: int):
        """The block cur [d, size/D] of a FRI layer -> the leaf rows
        [fold * d, L] of this rank's L = size/fold/D leaves: leaf j holds
        the values at j + t * size/fold. The run of L values at
        t * size/fold + r * L lies in one rank's block; one all-to-all
        brings each to rank r as row t."""
        D, s = self.D, self.rank
        d, L = cur.shape[0], size // fold // D
        dest = [(s * fold + u) % D for u in range(fold)]
        order = sorted(range(fold), key=lambda u: (dest[u], u))
        send = cur.reshape(d, fold, L).transpose(0, 1)[order]
        runs = [(t * fold + u) // D for t in range(D) for u in range(fold)
                if (t * fold + u) % D == s]
        got = self.mesh.all_to_all(
            send, [dest.count(r) for r in range(D)],
            [sum((t * fold + u) % D == s for u in range(fold))
             for t in range(D)])                           # [fold, d, L]
        rows = torch.empty_like(got)
        rows[runs] = got
        return rows.reshape(fold * d, L)

    def _fold_group(self, rows, xi, layer):
        """The fold of this rank's leaves (rows from _fri_group) -> its
        block [d, L] of the folded layer: one fri_fold launch on the values
        at the global positions j0 + j + t * size/fold, j0 = rank * L."""
        d, L = self.d, rows.shape[-1]
        return K.fri_fold(rows.reshape(layer.fold, d, L), xi, layer,
                          j0=self.rank * L)

    def _fri_layers(self, coin, cur, ck):
        """As Prover._fri_layers on the DEEP block cur [d, bn/D]; from the
        first layer of fewer than D leaves on, Prover._fri_layers on the
        gathered values, on every rank alike."""
        fri_layers = []
        fold = self.opts.fri_folding
        for i, layer in enumerate(self.fri_plan):
            if (layer.size // fold) % self.D:
                tail, rem = Prover._fri_layers(self, coin, self._gather(cur),
                                               None, first=i)
                return fri_layers + tail, rem
            rows = self._fri_group(cur, layer.size, fold)
            tree = self.commit(rows)
            coin.reseed(tree.root())
            cur = self._fold_group(rows, coin.draw_ext(self.d), layer)
            fri_layers.append(FRI.FriLayer(tree, layer.size, layer.offset,
                                           layer.gen, rows))
        return fri_layers, self._gather(cur)

    def _grind(self, coin):
        """Rank 0 searches; the nonce is broadcast."""
        if self.opts.grinding_bits == 0:
            return 0
        nonce = super()._grind(coin) if self.rank == 0 else 0
        return int(self.mesh.broadcast(torch.tensor(
            [nonce], dtype=torch.int64, device=self.device))[0])

    def _open(self, tree, rows, idx):
        if not isinstance(tree, ShardedTree):
            return super()._open(tree, rows, idx)
        i = torch.tensor(idx, dtype=torch.int64, device=rows.device)
        vals = rows.index_select(1, i % tree.m)
        return F.to_ints(self.mesh.gather_owned(vals, i // tree.m))

    def _paths(self, trees, indices_list):
        return [tree.paths(idx) if isinstance(tree, ShardedTree)
                else M.prove_batch_multi([tree], [idx])[0]
                for tree, idx in zip(trees, indices_list)]

    def prove(self, trace, mark=None, checkpoint=None):
        if checkpoint is not None:
            raise NotImplementedError(
                "ShardedProver: phase checkpoints are not ported for the "
                "sharded prover; prove without one")
        return super().prove(trace, mark=mark)


def prove_sharded(air, trace, mesh=None, hasher=None):
    """The proof of `air`'s statement for the whole trace [w, n] (on this
    rank's device), proven over the ranks of `mesh` (this process group's
    by default); the same Proof on every rank."""
    return ShardedProver(air, mesh, hasher).prove(trace)
