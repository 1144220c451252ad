"""The STARK prover pipeline on the device.

Counterpart of certificate_stark_tpu/engine/prover.py `Prover.prove`
(:1166-1404), in the same order: trace LDE -> trace commitment -> constraint
evaluation and composition -> composition commitment -> OOD frame -> DEEP
composition -> FRI layers -> grinding -> query openings. The device arrays
are int64 tensors of Montgomery values; the host runs the public coin between
phases and assembles the proof. With a checkpoint (`Prover.checkpointer`,
engine/checkpoint.py) each phase's tensors are saved, and a phase found in
the checkpoint is read instead of computed, with the JAX package's phase
keys (:1157-1349; the port has no packed LDE, so no `packed` key).

The trace and the constraint evaluations are base-field values. From the
composition on, the data lives in the extension of degree d
(opts.extension_degree; d = 1 is the base field): composition
coefficients, z, DEEP and FRI values are [d, ...] tensors with the
extension coordinate leading (ops/extfield.py), and every value that leaves
the device is flattened element-major, as the JAX package's `_flat` does.

Domains of up to `chunk` points (EVAL_CHUNK, 2^20, by default: the 128-
transaction proof's LDE) are one batch in every phase. A larger domain (the
1024-transaction proof's 2^23 points) is worked in contiguous segments of
`chunk` points: the constraint evaluation with the pointwise composition,
and the DEEP quotients, each segment written into one preallocated output.
Every value is computed pointwise (each inverse exactly), so the proof is
the same bytes at any chunk size. This is the JAX package's domain-chunked
evaluation (`_pick_eval_chunk`). Its column-group LDE (`_lde_cols`) has no
counterpart: the lde kernel takes every column at once with no scratch
beyond its output. Its packed LDE and per-row gathers have none either.
"""
from __future__ import annotations

import torch

from ..ops import extfield as XF, field as F, kernels as K, ntt as NTT
from ..utils import device as DV, poly_host as PH
from . import fri as FRI
from . import merkle as M
from .air import tile_periodic
from .boundary import build_boundary_tables
from .coin import RandomCoin
from .fieldops import BASE
from .hasher import get_hasher
from .proof import Proof, QueryOpening

EVAL_CHUNK = 1 << 20


def pick_chunk(bn: int, block: int, chunk=None) -> int:
    """Segment length of the domain-chunked phases: `chunk` (default
    EVAL_CHUNK), a power of two, raised to the periodic block length
    `block` where it is shorter, so that every segment starts at a multiple
    of the block; bn itself (one segment) where it is not smaller."""
    chunk = EVAL_CHUNK if chunk is None else chunk
    if chunk <= 0 or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two, not {chunk}")
    assert block & (block - 1) == 0
    return min(bn, max(chunk, block))


class Prover:
    coin_journal = None   # set to a list to record the coin's journal

    def __init__(self, air, device=None, hasher=None, chunk=None):
        opts = air.options
        self.device = dev = DV.resolve(device)
        self.air, self.opts = air, opts
        self.d = opts.extension_degree
        self.n, self.w, self.b = air.trace_length, air.trace_width, opts.blowup
        n, b = self.n, self.b
        self.bn = bn = b * n
        self.offset = offset = F.GENERATOR
        self.gen_big = gen_big = PH.root_of_unity(bn)
        self.g_trace = g_trace = PH.root_of_unity(n)
        self.hasher = hasher or get_hasher(opts.hash_fn)
        self.k = k = air.ce_blowup()
        self.degrees = air.transition_degrees()
        self.assertions = air.assertions()
        comp_deg = k * n - 1

        # the domain tables cover the points [j_lo, j_hi) of the LDE domain:
        # all of it here, a rank's block in the sharded prover
        self.j_lo, self.j_hi = j_lo, j_hi = self._domain()
        count = j_hi - j_lo
        # LDE-domain points x_j = offset * gen_big^j
        self.xs = F.mul(F.powers(gen_big, count, dev),
                        F.const(offset * pow(gen_big, j_lo, F.P), dev))
        # transition zerofier inverse (x - g^(n-1)) / (x^n - 1); x^n - 1
        # takes `b` distinct values on the coset, in turn (j_lo is a
        # multiple of b)
        o_n = pow(offset, n, F.P)
        znum = [pow(o_n * pow(gen_big, j * n, F.P) - 1, F.P - 2, F.P)
                for j in range(b)]
        self.zt_inv = F.mul(
            F.from_ints(znum, dev).repeat(count // b),
            F.sub(self.xs, F.const(pow(g_trace, n - 1, F.P), dev)))
        self.t_adjs = [comp_deg - (d.poly_degree(n) - (n - 1))
                       for d in self.degrees]
        self.b_tables = build_boundary_tables(
            self.assertions, n, bn, offset, g_trace, comp_deg, self.xs, j_lo)
        # x^adj on the domain, per degree adjustment
        self.xpow = {
            adj: F.mul(F.powers(pow(gen_big, adj, F.P), count, dev),
                       F.const(pow(offset, adj, F.P)
                               * pow(gen_big, adj * j_lo, F.P), dev))
            for adj in sorted(set(self.t_adjs)
                              | {g.adj for g in self.b_tables})}
        self.comp_tabs = self._compose_tables()
        # each FRI layer's fold constants
        self.fri_plan = FRI.plan(bn, offset, gen_big, opts, dev)
        # the transaction AIR's evaluation is the transaction_eval kernel;
        # every other AIR's its own evaluate_transition
        self.eval_consts = (
            air.eval_consts(dev)
            if getattr(air, "native_eval_kind", None) == "transaction"
            else None)
        per = air.periodic_lde(b, offset, dev)
        # segment length (count: unchunked); the periodic columns tiled to
        # one segment serve every segment, since segments start at
        # multiples of the periodic block. A block shorter than the
        # periodic block is one segment, read at its offset in the block.
        self.chunk = S = pick_chunk(count, per.shape[-1] if per is not None
                                    else 1, chunk)
        if per is None:
            self.periodic = torch.zeros((0, S), dtype=torch.int64, device=dev)
        elif S % per.shape[-1] == 0:
            self.periodic = tile_periodic(per, S)
        else:
            self.periodic = per.index_select(
                1, (torch.arange(j_lo, j_lo + S, device=dev)
                    % per.shape[-1]))

    def _compose_tables(self):
        """The composition's tables flattened for K.compose (its layout:
        ops/kernels.py ComposeTables): x^adj stacked [A, count], the
        boundary groups' inverse divisors [G, count] and the rows of the
        groups whose values vary [R, count]. self.xpow and each group's
        inv_z and b_evals become views of them, so nothing is held twice."""
        dev, count = self.device, self.j_hi - self.j_lo
        adjs = sorted(self.xpow)
        row = {adj: i for i, adj in enumerate(adjs)}
        xpow = torch.stack([self.xpow[adj] for adj in adjs])
        self.xpow = {adj: xpow[i] for i, adj in enumerate(adjs)}
        t_groups = [(row[adj], [c for c, a in enumerate(self.t_adjs)
                                if a == adj])
                    for adj in sorted(set(self.t_adjs))]

        def stacked(rows):
            return torch.cat(rows) if rows else torch.empty(
                (0, count), dtype=torch.int64, device=dev)
        b_invz = stacked([grp.inv_z[None] for grp in self.b_tables])
        b_ev = stacked([grp.b_evals for grp in self.b_tables
                        if grp.b_evals.shape[-1] != 1])
        index = {id(a): i for i, a in enumerate(self.assertions)}
        b_groups, r = [], 0
        for g, grp in enumerate(self.b_tables):
            grp.inv_z = b_invz[g]
            k = len(grp.assertions)
            if grp.b_evals.shape[-1] == 1:         # constants
                rows, vals = [-1] * k, grp.b_evals[:, 0].tolist()
            else:
                grp.b_evals = b_ev[r:r + k]
                rows, vals, r = list(range(r, r + k)), [0] * k, r + k
            b_groups.append((row[grp.adj], [
                (col, index[id(a)], rw, v) for col, a, rw, v in
                zip(grp.columns, grp.assertions, rows, vals)]))
        return K.compose_tables(xpow, self.zt_inv, b_invz, b_ev, t_groups,
                                b_groups)

    def _domain(self):
        """The LDE-domain points [j_lo, j_hi) this prover's tables and
        phases cover: the whole domain."""
        return 0, self.bn

    # ------------------------------------------------------------------
    def _segments(self):
        """The [j0, j1) domain segments of the chunked phases, relative to
        j_lo."""
        return [(j0, j0 + self.chunk)
                for j0 in range(0, self.j_hi - self.j_lo, self.chunk)]

    def _lde_from_coeffs(self, coeffs):
        """Coefficients [..., n] -> LDE [..., bn]: the lde kernel writes
        the output in place, pass after pass, with no scratch, so every
        domain size takes all rows at once."""
        return NTT.lde_from_coeffs(coeffs, self.b, self.offset)

    def phase_trace(self, trace):
        """trace [w, n] -> (coefficients [w, n], LDE [w, bn])."""
        coeffs = NTT.intt(trace)
        return coeffs, self._lde_from_coeffs(coeffs)

    def commit(self, rows):
        """Leaf-hash the columns of rows [r, m] and build the Merkle tree."""
        return M.MerkleTree.from_leaves(self.hasher,
                                        self.hasher.hash_columns(rows))

    def phase_composition(self, lde, t_alpha, t_beta, b_alpha, b_beta):
        """Constraint quotients and boundary terms combined into H(x) with
        the extension coefficients [d, C], segment by segment, split into
        k column polynomials -> (h_coeffs [d, k, n], h_lde [d, k, bn])."""
        comp = torch.cat([self._compose(lde, j0, j1, t_alpha, t_beta,
                                        b_alpha, b_beta)
                          for j0, j1 in self._segments()], dim=1)  # [d, bn]
        h_coeffs = self._split_composition(comp)
        return h_coeffs, self._lde_from_coeffs(h_coeffs)

    def _split_composition(self, comp):
        """H's values [d, bn] -> its column polynomials' coefficients
        [d, k, n]."""
        n, k, d = self.n, self.k, self.d
        # coefficients over the coset, then H_i(x) with H = sum x^i H_i(x^k)
        # (the scale by o^-i is fused into the inverse transform's last pass)
        coeffs = NTT.intt(comp, scale_by=pow(self.offset, F.P - 2, F.P))
        return coeffs[:, :k * n].reshape(d, n, k).transpose(1, 2) \
            .contiguous()                                       # [d, k, n]

    def _compose(self, lde, j0, j1, t_alpha, t_beta, b_alpha, b_beta):
        """H(x) on the domain points [j0, j1) -> [d, j1 - j0]: the
        transition constraints evaluated on the segment's frame (the
        transaction_eval kernel for the transaction AIR), then the
        pointwise composition (the compose kernel)."""
        cur, nxt = self._frame(lde, j0, j1)
        if self.eval_consts is not None:
            evals = K.transaction_eval(cur, nxt, self.periodic,
                                       self.eval_consts)
        else:
            evals = self.air.evaluate_transition(BASE, cur, nxt,
                                                 self.periodic)
        return K.compose(evals, cur, j0, self.comp_tabs, t_alpha, t_beta,
                         b_alpha, b_beta)

    def _frame(self, lde, j0, j1):
        """The trace LDE's rows at the points [j0, j1) and the next-row
        frame, the points j + b, wrapping at the domain's end."""
        nxt = lde.index_select(1, (torch.arange(j0, j1, device=lde.device)
                                   + self.b) % self.bn)
        return lde[:, j0:j1], nxt

    def ood_points(self, z):
        """z, z*g and z^k of the extension point z [d] -> [d, 3], from z's
        value on the host (a few extension products in Python ints)."""
        zs = [int(v) for v in F.to_ints(z)]
        zk = zs
        for _ in range(self.k.bit_length() - 1):
            zk = XF.host_ext_mul(zk, zk, self.d)
        return F.from_ints([[v, v * self.g_trace % F.P, vk]
                            for v, vk in zip(zs, zk)], z.device)

    def phase_ood(self, trace_coeffs, h_coeffs, z):
        """Trace polynomials at z and z*g, composition columns at z^k
        -> ood_z [d, w], ood_zg [d, w], ood_h [d, k]: the ood kernel."""
        return self._ood_sum(*K.ood(trace_coeffs, h_coeffs,
                                    self.ood_points(z), self._ood_start()))

    def _ood_start(self):
        """The power of the OOD points that meets this prover's first
        coefficient: 0, it holds them all."""
        return 0

    def _ood_sum(self, *parts):
        """The OOD values from this prover's sums over its coefficients:
        here they are the values."""
        return parts

    def phase_deep(self, lde, h_lde, ood_z, ood_zg, ood_h, g_z, g_zg, g_h,
                   z):
        """DEEP composition over the LDE domain, segment by segment ->
        [d, bn]: sum_j g_j (f_j(x) - f_j(p)) / (x - p) over the trace
        columns at p = z and z*g and the composition columns at z^k. One
        deep launch a segment, each writing its slice of the output."""
        pts = self.ood_points(z)
        out = torch.empty((self.d, self.j_hi - self.j_lo), dtype=torch.int64,
                          device=lde.device)
        for j0, j1 in self._segments():
            K.deep(lde[:, j0:j1], h_lde[..., j0:j1], self.xs[j0:j1], pts,
                   ood_z, ood_zg, ood_h, g_z, g_zg, g_h, out=out[:, j0:j1])
        return out

    # ------------------------------------------------------------------
    def _draw(self, coin, count):
        """count extension elements, d draws each -> [d, count]."""
        return XF.from_ints([coin.draw_ext(self.d) for _ in range(count)],
                            self.d, self.device)

    def _fri_layers(self, coin, cur, ck, first: int = 0):
        """The FRI commit phase on the DEEP values cur [d, bn]: a layer's
        leaf rows committed, the coin reseeded with its root and the
        folding scalar drawn, until at most fri_max_remainder values are
        left -> (layers, the remainder [d, size]). Only the first layer's
        rows are copied from cur; each fold writes the next layer's rows
        itself, the last one the remainder, so a layer is held once.
        From layer `first` on, with cur that layer's whole values (the
        sharded prover's layers that every rank folds alike)."""
        hasher, fold = self.hasher, self.opts.fri_folding
        fri_layers, rows = [], None
        for i in range(first, len(self.fri_plan)):
            layer = self.fri_plan[i]
            key = f"fri{i}"
            data = ck.load(key) if ck else None
            if data is not None:
                rows = data["group"]
                tree = M.MerkleTree(hasher, ck.unpack_levels(data))
            else:
                if rows is None:
                    rows = FRI.leaf_rows(cur, fold)
                tree = Prover.commit(self, rows)   # whole rows, one holder
                if ck:
                    ck.save_levels(key, {"group": rows}, tree.levels)
            coin.reseed(tree.root())
            last = i + 1 == len(self.fri_plan)
            out = FRI.fold(rows, coin.draw_ext(self.d), layer,
                           0 if last else fold)
            fri_layers.append(FRI.FriLayer(tree, layer.size, layer.offset,
                                           layer.gen, rows))
            rows, cur = (None, out) if last else (out, None)
        return fri_layers, cur

    def _grind(self, coin):
        """The proof-of-work nonce for the coin's state."""
        return coin.grind(self.opts.grinding_bits, device=self.device)

    def _open(self, tree, rows, idx):
        """The committed rows [r, m] of `tree` at the leaves idx -> [r, Q]
        standard-form ints."""
        return F.to_ints(rows.index_select(
            1, torch.tensor(idx, dtype=torch.int64, device=rows.device)))

    def _paths(self, trees, indices_list):
        """Authentication paths, one {index: path} dict per tree."""
        return M.prove_batch_multi(trees, indices_list)

    def checkpointer(self, directory: str):
        """A phase Checkpointer bound to this proving context (the AIR,
        its shape, the options, the public inputs and the hasher), for
        `prove(..., checkpoint=...)`."""
        from .checkpoint import Checkpointer
        ctx = [type(self.air).__name__, self.w, self.n,
               self.opts.context_elements(self.w, self.n),
               self.air.pub_inputs_elements(), self.hasher.name]
        return Checkpointer(directory, context=ctx, device=self.device)

    def prove(self, trace: torch.Tensor, mark=None, checkpoint=None) -> Proof:
        """Prove the AIR's statement for `trace` [w, n] (Montgomery int64
        on the prover's device). `mark(label)`, when given, is called at
        every phase boundary (chip_smoke.py times the phases with it).

        With a `checkpoint` (self.checkpointer(directory)), each phase
        saves its device tensors under its key (trace, composition, deep,
        fri0, fri1, ..., pow), and a phase whose artifact the directory
        holds for this context is not computed again: its tensors come
        from the file, and the coin is replayed from the restored roots.
        The proof is the same bytes either way."""
        air, opts, hasher = self.air, self.opts, self.hasher
        n, w, bn, k, d = self.n, self.w, self.bn, self.k, self.d
        assert tuple(trace.shape) == (w, n) and trace.device == self.device
        mark = mark or (lambda label: None)
        ck = checkpoint

        data = ck.load("trace") if ck else None
        if data is not None:
            del trace             # every value comes from the checkpoint
            trace_coeffs, lde = data["trace_coeffs"], data["lde"]
            trace_tree = M.MerkleTree(hasher, ck.unpack_levels(data))
            mark("trace LDE")
        else:
            trace_coeffs, lde = self.phase_trace(trace)
            mark("trace LDE")
            trace_tree = self.commit(lde)
            if ck:
                ck.save_levels("trace", {"trace_coeffs": trace_coeffs,
                                         "lde": lde}, trace_tree.levels)
        coin = RandomCoin(hasher, opts.context_elements(w, n)
                          + air.pub_inputs_elements(),
                          journal=self.coin_journal)
        coin.reseed(trace_tree.root())
        mark("trace commit")

        nc, nb = len(self.degrees), len(self.assertions)
        t_alpha, t_beta = self._draw(coin, nc), self._draw(coin, nc)
        b_alpha, b_beta = self._draw(coin, nb), self._draw(coin, nb)
        data = ck.load("composition") if ck else None
        if data is not None:
            h_coeffs, h_lde = data["h_coeffs"], data["h_lde"]
            h_levels = ck.unpack_levels(data)
        else:
            h_coeffs, h_lde = self.phase_composition(lde, t_alpha, t_beta,
                                                     b_alpha, b_beta)
        mark("constraint eval + composition")
        # committed rows: column i's d coordinates at rows i*d .. i*d + d-1
        h_rows = h_lde.transpose(0, 1).reshape(k * d, h_lde.shape[-1])
        if data is not None:
            h_tree = M.MerkleTree(hasher, h_levels)
        else:
            h_tree = self.commit(h_rows)
            if ck:
                ck.save_levels("composition", {"h_coeffs": h_coeffs,
                                               "h_lde": h_lde}, h_tree.levels)
        coin.reseed(h_tree.root())
        mark("composition commit")

        z = F.from_ints(coin.draw_ext(d), self.device)
        data = ck.load("deep") if ck else None
        if data is not None:
            oods = data["ood_z"], data["ood_zg"], data["ood_h"]
        else:
            oods = self.phase_ood(trace_coeffs, h_coeffs, z)
        ood_z, ood_zg, ood_h = (XF.flat_ints(o) for o in oods)
        coin.reseed(hasher.host_digest(ood_z + ood_zg + ood_h))
        g_z, g_zg, g_h = (self._draw(coin, w), self._draw(coin, w),
                          self._draw(coin, k))
        if data is not None:
            deep = data["deep"]
        else:
            deep = self.phase_deep(lde, h_lde, *oods, g_z, g_zg, g_h, z)
            if ck:
                ck.save("deep", ood_z=oods[0], ood_zg=oods[1], ood_h=oods[2],
                        deep=deep)
        mark("OOD + DEEP")

        fri_layers, cur = self._fri_layers(coin, deep, ck)
        remainder = XF.flat_ints(cur)
        coin.reseed(hasher.host_digest(remainder))
        mark("FRI layers")

        data = ck.load("pow") if ck else None
        if data is not None:
            nonce = int(data["nonce"])
        else:
            nonce = self._grind(coin)
            if ck:
                ck.save("pow", nonce=nonce)
        coin.reseed(hasher.host_digest([nonce]))
        positions = coin.draw_indices(opts.num_queries, bn)
        leaf_idxs, p_cur = [], list(positions)
        for layer in fri_layers:
            p_cur = [p % (layer.n // opts.fri_folding) for p in p_cur]
            leaf_idxs.append(p_cur)

        lde_host = self._open(trace_tree, lde, positions)
        h_host = self._open(h_tree, h_rows, positions)
        fri_vals = [self._open(layer.tree, layer.group, idx)
                    for layer, idx in zip(fri_layers, leaf_idxs)]
        all_paths = self._paths(
            [trace_tree, h_tree] + [layer.tree for layer in fri_layers],
            [positions, positions] + leaf_idxs)
        t_paths, h_paths = all_paths[0], all_paths[1]

        queries = []
        for qi, pos in enumerate(positions):
            fri_open = [([int(v) for v in vals[:, qi]], paths[idx[qi]])
                        for idx, vals, paths in
                        zip(leaf_idxs, fri_vals, all_paths[2:])]
            queries.append(QueryOpening(
                index=int(pos),
                trace_row=[int(x) for x in lde_host[:, qi]],
                h_row=[int(x) for x in h_host[:, qi]],
                trace_path=t_paths[int(pos)],
                h_path=h_paths[int(pos)],
                fri_openings=fri_open,
            ))
        mark("query openings")
        return Proof(
            trace_width=w, trace_length=n, options=opts,
            pub_inputs=air.pub_inputs_elements(),
            trace_root=trace_tree.root(), h_root=h_tree.root(),
            ood_trace_z=ood_z, ood_trace_zg=ood_zg, ood_h=ood_h,
            fri_roots=[layer.tree.root() for layer in fri_layers],
            fri_remainder=remainder, pow_nonce=nonce, queries=queries,
        )
