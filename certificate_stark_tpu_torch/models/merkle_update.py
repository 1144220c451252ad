"""Merkle-update sub-AIR — reference src/merkle/update/: proves two Merkle
authentication-path updates (sender & receiver) per transaction over a
depth-`d` Rescue tree. Width 65, 512 steps a transaction, hash phase
8*d+7 steps. Counterpart of certificate_stark_tpu/models/merkle_update.py;
its register map, host trace step and constraint blocks also serve the
composed state-transition AIR.

Register map (src/merkle/constants.rs:31-63):
  0..14  sender old-path hash state     14      sender index bit
  15..29 sender new-path hash state     29..43  receiver old-path hash state
  43     receiver index bit             44..58  receiver new-path hash state
  58..65 previous-root carry
Constraint slots: 0..58 auth clusters (with the sender/receiver bit at
14/43), 58..65 root carry, 65..90 key/nonce copies, 90 balance, 91 sender
nonce, 92..99 intermediate-root equality, 99..106 previous-root match.

Quirk replicated: index-bit registers are forced to 1 at global row 1 for
constraint-degree stability (update/prover.rs:72-77).
"""
from __future__ import annotations

from ..engine.air import Air, Assertion, ConstraintDegree
from ..engine.prover import Prover
from ..ops import rescue as R
from ..params import data as D
from ..params.data import P
from ..utils import device as DV, rescue_ref as RR
from .constraints import rescue_enforce_round

TRACE_WIDTH = 65
CYCLE = 512
S_INIT, S_BIT, S_UPD = 0, 14, 15
R_INIT, R_BIT, R_UPD = 29, 43, 44
PREV_ROOT = 58


def hash_length(depth):
    return 8 * depth + 7


def _auth_update(row, base, step, index, path):
    """One step of a cluster pair's authentication-path hash, in place on a
    host row of ints (update/trace.rs:96-136)."""
    cyc, pos = divmod(step, 8)
    if pos < 7:
        row[base:base + 14] = RR.apply_round(row[base:base + 14], step)
        row[base + 15:base + 29] = RR.apply_round(row[base + 15:base + 29],
                                                  step)
    elif pos == 7:
        node = list(path[cyc + 1])
        bit = (index >> cyc) & 1
        if bit == 0:
            row[base + 7:base + 14] = node
            row[base + 15 + 7:base + 15 + 14] = node
        else:
            row[base + 7:base + 14] = row[base:base + 7]
            row[base + 15 + 7:base + 15 + 14] = row[base + 15:base + 15 + 7]
            row[base:base + 7] = node
            row[base + 15:base + 15 + 7] = node
        row[base + 14] = bit


def tx_rows(initial_root, s_old, r_old, delta, s_idx, r_idx, s_path, r_path,
            depth):
    """One 512-row transaction window as a list of 65-int rows
    (update/trace.rs:19-136): the host reference of `build_trace`."""
    thl = hash_length(depth)
    row = [0] * TRACE_WIDTH
    row[S_INIT:S_INIT + 14] = [v % P for v in s_old]
    row[S_UPD:S_UPD + 14] = [v % P for v in s_old]
    row[S_UPD + 12] = (s_old[12] - delta) % P
    row[S_UPD + 13] = (s_old[13] + 1) % P
    row[R_INIT:R_INIT + 14] = [v % P for v in r_old]
    row[R_UPD:R_UPD + 14] = [v % P for v in r_old]
    row[R_UPD + 12] = (r_old[12] + delta) % P
    row[PREV_ROOT:PREV_ROOT + 7] = list(initial_root)
    rows = [list(row)]
    for step in range(CYCLE - 1):
        row = list(row)
        if step < thl:
            _auth_update(row, S_INIT, step, s_idx, s_path)
            _auth_update(row, R_INIT, step, r_idx, r_path)
        if step == thl - 1:
            row[PREV_ROOT:PREV_ROOT + 7] = row[R_UPD:R_UPD + 7]
        rows.append(row)
    return rows


def build_trace(txs, depth, device=None):
    """txs: list of dicts with keys initial_root, s_old, r_old, delta, s_idx,
    r_idx, s_path, r_path. Returns the Montgomery trace [65, 512*len(txs)]
    on `device`, built by the composed AIR's trace kernel
    (models/trace_device.py `build_trace_mu`)."""
    from .trace_device import build_trace_mu
    return build_trace_mu(txs, depth, DV.resolve(device))


class MerkleUpdateAir(Air):
    """Public inputs: (initial_root[7], final_root[7]); depth via air kwarg."""

    name = "merkle-update"
    trace_width = TRACE_WIDTH

    def __init__(self, trace_length, pub_inputs, options, depth=15):
        super().__init__(trace_length, pub_inputs, options)
        self.depth = depth
        self.initial_root = [int(x) % P for x in pub_inputs[0]]
        self.final_root = [int(x) % P for x in pub_inputs[1]]

    def transition_degrees(self):
        c = (CYCLE,)
        auth = ([ConstraintDegree(3, c)] * 14 + [ConstraintDegree(2, c)]
                + [ConstraintDegree(3, c)] * 14)
        rest = [ConstraintDegree(1, c)] * 48
        return auth + auth + rest

    def periodic_columns(self):
        thl = hash_length(self.depth)
        setup = [1] + [0] * (CYCLE - 1)
        tx_hash = [1] * thl + [0] * (CYCLE - thl)
        hash_input = [0] * 7 + [1]
        finish = [0] * (thl - 1) + [1] + [0] * (CYCLE - thl)
        hash_flag = [tx_hash[i] * (1 if i % 8 < 7 else 0)
                     for i in range(CYCLE)]
        cols = [setup, tx_hash, hash_input, finish, hash_flag]
        for j in range(2 * R.STATE_WIDTH):
            cols.append([D.RESCUE_ARK[i][j] for i in range(R.CYCLE_LENGTH)])
        return cols

    def evaluate_transition(self, fx, current, nxt, periodic):
        setup, tx_hash, hash_input, finish, hash_flag = (
            fx.col(periodic, i)[None] for i in range(5))       # [1, B]
        ark0 = fx.cols(periodic, 5, 19)
        ark1 = fx.cols(periodic, 19, 33)

        res = [None] * 106

        def agg(idx, val):
            res[idx] = val if res[idx] is None else fx.add(res[idx], val)

        evaluate_setup_values(fx, current, agg, setup)
        evaluate_merkle_auth(fx, current, nxt, agg, ark0, ark1, tx_hash,
                             hash_input, finish, hash_flag)
        return fx.stack(res)

    def assertions(self):
        last = self.trace_length - 1
        return ([Assertion(PREV_ROOT + i, 0, self.initial_root[i])
                 for i in range(7)]
                + [Assertion(PREV_ROOT + i, last, self.final_root[i])
                   for i in range(7)])


class MerkleUpdateExample:
    """Mirrors update/mod.rs TransactionExample (depth is a parameter here;
    the reference switches 3/15 via #[cfg(test)], merkle/constants.rs:20-25).
    The witness is built on the host in __init__; `trace` builds the trace
    on the device. Runs on the card unless `device` names another."""

    def __init__(self, num_transactions: int, options, depth: int = 15,
                 seed: int = 1, device=None):
        from ..utils import witness as W
        self.options = options
        self.depth = depth
        self.device = DV.resolve(device)
        self.md = W.build_random(num_transactions, depth, seed)

    @property
    def trace(self):
        """Built on demand, not cached."""
        return build_trace(self.md.tx_dicts(), self.depth, self.device)

    def pub_inputs(self):
        return (list(self.md.initial_roots[0]), list(self.md.final_root))

    def air(self):
        return MerkleUpdateAir(CYCLE * len(self.md.deltas), self.pub_inputs(),
                               self.options, depth=self.depth)

    def prove(self):
        return Prover(self.air(), self.device).prove(self.trace)

    def verify(self, proof, pub_inputs=None):
        """The port's verifier on the host, with this example's options and
        depth."""
        from ..engine import verifier as V
        return V.verify(MerkleUpdateAir, proof,
                        pub_inputs or self.pub_inputs(),
                        air_kwargs={"depth": self.depth},
                        expected_options=self.options)


def evaluate_setup_values(fx, current, agg, setup):
    """Key/balance/nonce value constraints at transaction setup
    (update/air.rs:84-134); result slots 65..92. setup: [1, B]."""
    s_keys = fx.mul(fx.sub(fx.cols(current, S_INIT, S_INIT + 12),
                           fx.cols(current, S_UPD, S_UPD + 12)), setup)
    r_keys = fx.mul(fx.sub(fx.cols(current, R_INIT, R_INIT + 12),
                           fx.cols(current, R_UPD, R_UPD + 12)), setup)
    for i in range(12):
        agg(65 + i, s_keys[i])
        agg(65 + 12 + i, r_keys[i])
    agg(89, fx.mul(fx.sub(fx.col(current, R_INIT + 13),
                          fx.col(current, R_UPD + 13)), setup[0]))
    bal = fx.sub(fx.sub(fx.col(current, S_INIT + 12),
                        fx.col(current, S_UPD + 12)),
                 fx.sub(fx.col(current, R_UPD + 12),
                        fx.col(current, R_INIT + 12)))
    agg(90, fx.mul(bal, setup[0]))
    nonce = fx.sub(fx.col(current, S_UPD + 13),
                   fx.add(fx.col(current, S_INIT + 13),
                          fx.const(1, current)))
    agg(91, fx.mul(nonce, setup[0]))


def evaluate_merkle_auth(fx, current, nxt, agg, ark0, ark1, tx_hash,
                         hash_input, finish, hash_flag):
    """Merkle authentication-path constraints (update/air.rs:215-369);
    result slots 0..65 and 92..106. The flags are [1, B]."""
    one = fx.const(1, current)
    not_finish = fx.sub(one, finish)
    not_input = fx.sub(one, fx.add(hash_flag, hash_input))
    copy_flag = fx.mul(tx_hash, not_input)
    init_flag = fx.mul(tx_hash, hash_input)

    # auth clusters (sender at 0/15 -> res 0..29; receiver at 29/44 -> 29..58)
    for res_base, tr_base, bit_pos in ((0, S_INIT, S_BIT), (29, R_INIT, R_BIT)):
        bit_el = fx.col(nxt, bit_pos)
        bit = bit_el[None]
        not_bit = fx.sub(one, bit)
        agg(res_base + 14, fx.mul(
            fx.sub(fx.mul(bit_el, bit_el), bit_el), tx_hash[0]))
        for roff, reg in ((0, tr_base), (15, tr_base + 15)):
            cur14 = fx.cols(current, reg, reg + 14)
            nxt14 = fx.cols(nxt, reg, reg + 14)
            round_c = fx.mul(rescue_enforce_round(fx, cur14, nxt14, ark0,
                                                  ark1), hash_flag)
            for i in range(14):
                agg(res_base + roff + i, round_c[i])
            cp = fx.mul(fx.sub(fx.cols(current, reg, reg + 7),
                               fx.cols(nxt, reg, reg + 7)), copy_flag)
            ini = fx.mul(fx.mul(fx.sub(fx.cols(current, reg, reg + 7),
                                       fx.cols(nxt, reg, reg + 7)), not_bit),
                         init_flag)
            mv = fx.mul(fx.mul(fx.sub(fx.cols(current, reg, reg + 7),
                                      fx.cols(nxt, reg + 7, reg + 14)), bit),
                        init_flag)
            for i in range(7):
                agg(res_base + roff + i, fx.add(cp[i], ini[i]))
                agg(res_base + roff + 7 + i, mv[i])
        # same-sibling constraints between old/new clusters
        sib_lo = fx.mul(fx.mul(fx.sub(fx.cols(nxt, tr_base + 15, tr_base + 22),
                                      fx.cols(nxt, tr_base, tr_base + 7)), bit),
                        init_flag)
        sib_hi = fx.mul(fx.mul(fx.sub(fx.cols(nxt, tr_base + 22, tr_base + 29),
                                      fx.cols(nxt, tr_base + 7, tr_base + 14)),
                               not_bit), init_flag)
        for i in range(7):
            agg(res_base + i, sib_lo[i])
            agg(res_base + 7 + i, sib_hi[i])

    # previous-root carry (res 58..65)
    keep = fx.mul(fx.sub(fx.cols(nxt, PREV_ROOT, PREV_ROOT + 7),
                         fx.cols(current, PREV_ROOT, PREV_ROOT + 7)), not_finish)
    load = fx.mul(fx.sub(fx.cols(nxt, PREV_ROOT, PREV_ROOT + 7),
                         fx.cols(nxt, R_UPD, R_UPD + 7)), finish)
    for i in range(7):
        agg(58 + i, fx.add(keep[i], load[i]))

    # intermediate-root equality (92..99) / prev-root match (99..106)
    int_eq = fx.mul(fx.sub(fx.cols(current, S_UPD, S_UPD + 7),
                           fx.cols(current, R_INIT, R_INIT + 7)), finish)
    pm = fx.mul(fx.sub(fx.cols(nxt, S_INIT, S_INIT + 7),
                       fx.cols(current, PREV_ROOT, PREV_ROOT + 7)), finish)
    for i in range(7):
        agg(92 + i, int_eq[i])
        agg(99 + i, pm[i])
