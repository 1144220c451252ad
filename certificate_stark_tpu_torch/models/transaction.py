"""The composed state-transition AIR (reference src/air.rs, src/trace.rs,
src/prover.rs, src/constants.rs). Counterpart of
certificate_stark_tpu/models/transaction.py.

Each transaction occupies a 1024-step window over a 94-wide trace:
  steps 0..510   Merkle update sub-program on cols 0..65
  step  511      Schnorr + range initialization (cols 0..58, 92..94)
  steps 512..1023 Schnorr verification on cols 0..56, with 64-bit range
                 proofs on delta (cols 56..58) and sigma (cols 92..94)
  cols 65..92    copy registers: sender/receiver keys, delta, sigma, nonce

Periodic 0/1 mask columns gate the constraint families over shared result
slots, which are summed (115 slots).

Reference quirks replicated (SURVEY.md §2d):
  * boundary assertions check only root elements 0 and 1 (air.rs:178-183);
  * the sigma range-check endpoint compares the DELTA registers again
    (air.rs:605-609): sigma's endpoint equality is not enforced;
  * merkle-init constraints overlap merkle-update's at setup (summed).
"""
from __future__ import annotations

from ..engine.air import Air, Assertion, ConstraintDegree
from ..engine.prover import Prover
from ..ops import field as F, rescue as R
from ..params import data as D
from ..params.data import P
from ..utils import curve as CV, device as DV
from . import merkle_update as MU
from . import schnorr as SC
from .constraints import double_and_add, rescue_enforce_round

TRACE_WIDTH = 94
CYCLE = 1024
N_CONSTRAINTS = 115

S_KEY_COPY, R_KEY_COPY = 65, 77
DELTA_COPY, SIGMA_COPY, NONCE_COPY = 89, 90, 91
DELTA_BIT, DELTA_ACC = 56, 57
SIGMA_BIT, SIGMA_ACC = 92, 93

SENDER_KEY_RES, RECEIVER_KEY_RES = 101, 103
DELTA_COPY_RES, SIGMA_COPY_RES, NONCE_COPY_RES = 105, 106, 107
DELTA_RANGE_RES, SIGMA_RANGE_RES = 108, 109

RANGE_LOG = 64
VALUE_COPY_END = 512 + RANGE_LOG  # 576 (== 512 + max(3*8-1, 64))


def hash_length(depth):
    return 8 * depth + 7


def init_row(t) -> list:
    """Row 0 of a transaction window, standard-form ints
    (src/trace.rs:28-53)."""
    delta = t["delta"]
    row = [0] * TRACE_WIDTH
    row[MU.S_INIT:MU.S_INIT + 14] = [v % P for v in t["s_old"]]
    row[MU.S_UPD:MU.S_UPD + 14] = [v % P for v in t["s_old"]]
    row[MU.S_UPD + 12] = (t["s_old"][12] - delta) % P
    row[MU.S_UPD + 13] = (t["s_old"][13] + 1) % P
    row[MU.R_INIT:MU.R_INIT + 14] = [v % P for v in t["r_old"]]
    row[MU.R_UPD:MU.R_UPD + 14] = [v % P for v in t["r_old"]]
    row[MU.R_UPD + 12] = (t["r_old"][12] + delta) % P
    row[MU.PREV_ROOT:MU.PREV_ROOT + 7] = list(t["initial_root"])
    row[S_KEY_COPY:S_KEY_COPY + 12] = [v % P for v in t["s_old"][:12]]
    row[R_KEY_COPY:R_KEY_COPY + 12] = [v % P for v in t["r_old"][:12]]
    row[DELTA_COPY] = delta % P
    row[SIGMA_COPY] = (t["s_old"][12] - delta) % P
    row[NONCE_COPY] = t["s_old"][13] % P
    return row


def tx_rows(t, depth, message, signature):
    """One 1024-row transaction window as host ints (src/trace.rs:28-142):
    the reference for the trace kernel and its plain version."""
    thl = hash_length(depth)
    pkey12, s_bits, h_bits = SC.build_sig_info(message, signature)
    gen12 = SC._gen12()
    delta = t["delta"]
    sigma = (t["s_old"][12] - delta) % P
    delta_bits = [(delta >> i) & 1 for i in range(64)]
    sigma_bits = [(sigma >> i) & 1 for i in range(64)]

    row = init_row(t)
    rows = [list(row)]
    for step in range(CYCLE - 1):
        row = list(row)
        if step < 511:
            if step < thl:
                MU._auth_update(row, MU.S_INIT, step, t["s_idx"], t["s_path"])
                MU._auth_update(row, MU.R_INIT, step, t["r_idx"], t["r_path"])
            if step == thl - 1:
                row[MU.PREV_ROOT:MU.PREV_ROOT + 7] = row[MU.R_UPD:MU.R_UPD + 7]
        elif step == 511:
            SC.init_sig_state(row, signature[0])
            row[DELTA_BIT] = row[DELTA_ACC] = 0
            row[SIGMA_BIT] = row[SIGMA_ACC] = 0
        else:
            sstep = step - 512
            SC.sig_step(row, sstep, message, pkey12, s_bits, h_bits, gen12)
            if sstep < RANGE_LOG:
                row[DELTA_BIT] = delta_bits[RANGE_LOG - 1 - sstep]
                row[DELTA_ACC] = (2 * row[DELTA_ACC] + row[DELTA_BIT]) % P
                row[SIGMA_BIT] = sigma_bits[RANGE_LOG - 1 - sstep]
                row[SIGMA_ACC] = (2 * row[SIGMA_ACC] + row[SIGMA_BIT]) % P
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
class TransactionAir(Air):
    """Public inputs: (initial_root[7], final_root[7]); depth via kwarg."""

    name = "transaction"
    trace_width = TRACE_WIDTH

    def __init__(self, trace_length, pub_inputs, options, depth=15):
        super().__init__(trace_length, pub_inputs, options)
        self.depth = depth
        self.initial_root = [int(x) % P for x in pub_inputs[0]]
        self.final_root = [int(x) % P for x in pub_inputs[1]]

    def transition_degrees(self):
        c = (CYCLE,)
        cc = (CYCLE, CYCLE)
        deg = []
        deg += [ConstraintDegree(5, cc)] * 6      # 0..6   x(S) + reduce
        deg += [ConstraintDegree(4, cc)] * 12     # 6..18  y,z(S)
        deg += [ConstraintDegree(3, cc)] * 1      # 18
        deg += [ConstraintDegree(5, cc)] * 18     # 19..37 h.P
        deg += [ConstraintDegree(3, cc)] * 1      # 37
        deg += [ConstraintDegree(3, cc)] * 18     # 38..56
        deg += [ConstraintDegree(3, cc)] * 2      # 56,57  (+ delta range)
        deg += [ConstraintDegree(1, c)] * 7       # 58..65 prev root
        deg += [ConstraintDegree(1, c)] * 25      # 65..90 value copies
        deg += [ConstraintDegree(1, c)] * 2       # 90,91
        deg += [ConstraintDegree(2, c)] * 1       # 92 int eq + sigma bit
        deg += [ConstraintDegree(1, c)] * 6       # 93..99
        deg += [ConstraintDegree(1, c)] * 2       # 99..101 prev match
        deg += [ConstraintDegree(1, c)] * 14      # 101..115 copies/ranges
        assert len(deg) == N_CONSTRAINTS
        return deg

    def periodic_columns(self):
        thl = hash_length(self.depth)
        z, o = 0, 1
        setup = [o] + [z] * (CYCLE - 1)
        merkle_mask = [o] * thl + [z] * (CYCLE - thl)
        hash_input = [z] * 7 + [o]
        finish = [z] * (thl - 1) + [o] + [z] * (CYCLE - thl)
        hash_mask = [(o if (i < thl and i % 8 < 7) else z)
                     for i in range(CYCLE)]
        schnorr_mask = [z] * 512 + [o] * 511 + [z]
        scalar_mult = [z] * 512 + [o] * 510 + [z, z]
        doubling = [z] * 512 + [o, z] * 255 + [z, z]
        digest = [[z] * CYCLE for _ in range(4)]
        digest[0][512:512 + 126] = [o] * 126
        digest[1][512 + 126:512 + 254] = [o] * 128
        digest[2][512 + 254:512 + 382] = [o] * 128
        digest[3][512 + 382:512 + 510] = [o] * 128
        schnorr_hash = [z] * 512 + ([o] * 7 + [z]) * 5 + [z] * (512 - 40)
        internal_flags = [[z] * CYCLE for _ in range(4)]
        for k in range(4):
            internal_flags[k][512 + (k + 1) * 8 - 1] = o
        range_step = [z] * 512 + [o] * RANGE_LOG + [z] * (512 - RANGE_LOG)
        range_finish = ([z] * (512 + RANGE_LOG - 1) + [o]
                        + [z] * (512 - RANGE_LOG))
        value_copy = ([z] + [o] * (VALUE_COPY_END - 1)
                      + [z] * (CYCLE - VALUE_COPY_END))
        cols = [setup, merkle_mask, hash_input, finish, hash_mask,
                schnorr_mask, scalar_mult, doubling] + digest \
            + [schnorr_hash] + internal_flags \
            + [range_step, range_finish, value_copy]
        for j in range(28):
            cols.append([D.RESCUE_ARK[i][j] for i in range(8)])
        return cols

    # the prover evaluates this AIR with the transaction_eval kernel
    # (ops/kernels.py), the JAX package's native-evaluator kind
    native_eval_kind = "transaction"

    def eval_consts(self, device):
        """The transaction_eval kernel's constant tables on `device`
        (Montgomery): the Rescue MDS and inverse MDS, and the active
        curve's gen12 and b3."""
        mds, inv_mds, _ = R.tables(device)
        return dict(mds=mds, inv_mds=inv_mds,
                    gen12=F.from_ints(CV.GEN12, device),
                    b3=F.from_ints(CV.B3_LIMBS, device))

    @staticmethod
    def evaluate_transition(fx, current, nxt, periodic, gen12=None, b3=None):
        """The 115 transition-constraint slots on frames current / nxt
        [94, B] with the periodic columns [48, B]; gen12 and b3
        (standard-form ints) default to the active curve's."""
        def flag(i):                                   # [1, B]
            return fx.col(periodic, i)[None]
        setup, merkle_mask, hash_input, finish = (flag(i) for i in range(4))
        hash_mask, schnorr_mask, scalar_mult, doubling = \
            (flag(i) for i in range(4, 8))
        digest_flags = [flag(8 + i) for i in range(4)]
        schnorr_hash = flag(12)
        internal_flags = [flag(13 + i) for i in range(4)]
        range_step, range_finish, value_copy = (flag(i) for i in (17, 18, 19))
        ark0 = fx.cols(periodic, 20, 34)
        ark1 = fx.cols(periodic, 34, 48)

        one = fx.const(1, current)
        copy_hash = fx.mul(fx.sub(one, schnorr_hash), schnorr_mask)
        final_flag = fx.mul(fx.sub(one, scalar_mult), schnorr_mask)
        addition = fx.mul(fx.sub(one, doubling), scalar_mult)

        res = [None] * N_CONSTRAINTS

        def agg(idx, val):
            res[idx] = val if res[idx] is None else fx.add(res[idx], val)

        # 1. merkle-init rounds at setup (init/air.rs:166-198; slots 0..56)
        for res_base, pos in ((0, MU.S_INIT), (14, MU.S_UPD),
                              (28, MU.R_INIT), (42, MU.R_UPD)):
            rc = fx.mul(rescue_enforce_round(
                fx, fx.cols(current, pos, pos + 14),
                fx.cols(nxt, pos, pos + 14), ark0, ark1), setup)
            for i in range(14):
                agg(res_base + i, rc[i])

        # 2. setup value constraints (slots 65..92)
        MU.evaluate_setup_values(fx, current, agg, setup)

        # 3. key/delta/sigma/nonce copy setup + carry (slots 101..108)
        for res_idx, origin, copy_pos in (
                (SENDER_KEY_RES, MU.S_INIT, S_KEY_COPY),
                (RECEIVER_KEY_RES, MU.R_INIT, R_KEY_COPY)):
            st = fx.mul(fx.sub(fx.cols(nxt, copy_pos, copy_pos + 12),
                               fx.cols(current, origin, origin + 12)), setup)
            cp = fx.mul(fx.sub(fx.cols(nxt, copy_pos, copy_pos + 12),
                               fx.cols(current, copy_pos, copy_pos + 12)),
                        value_copy)
            for i in range(12):
                agg(res_idx + i, fx.add(st[i], cp[i]))
        delta_src = fx.sub(fx.col(current, MU.S_INIT + 12),
                           fx.col(current, MU.S_UPD + 12))
        agg(DELTA_COPY_RES, fx.mul(fx.sub(fx.col(nxt, DELTA_COPY), delta_src),
                                   setup[0]))
        agg(SIGMA_COPY_RES, fx.mul(fx.sub(fx.col(nxt, SIGMA_COPY),
                                          fx.col(current, MU.S_UPD + 12)),
                                   setup[0]))
        agg(NONCE_COPY_RES, fx.mul(fx.sub(fx.col(nxt, NONCE_COPY),
                                          fx.col(current, MU.S_INIT + 13)),
                                   setup[0]))
        for res_idx, copy_pos in ((DELTA_COPY_RES, DELTA_COPY),
                                  (SIGMA_COPY_RES, SIGMA_COPY),
                                  (NONCE_COPY_RES, NONCE_COPY)):
            agg(res_idx, fx.mul(fx.sub(fx.col(nxt, copy_pos),
                                       fx.col(current, copy_pos)),
                                value_copy[0]))

        # 4. merkle auth constraints (slots 0..65, 92..106)
        MU.evaluate_merkle_auth(fx, current, nxt, agg, ark0, ark1,
                                merkle_mask, hash_input, finish, hash_mask)

        # 5. schnorr constraints with copy-register-driven pkey and hash
        #    internal inputs (air.rs:542-583; slots 0..56)
        pkey = fx.cols(nxt, S_KEY_COPY, S_KEY_COPY + 12)
        internal = None
        srcs = [fx.cols(nxt, S_KEY_COPY, S_KEY_COPY + 7),
                fx.cat1([fx.cols(nxt, S_KEY_COPY + 7, S_KEY_COPY + 12),
                         fx.cols(nxt, R_KEY_COPY, R_KEY_COPY + 2)]),
                fx.cols(nxt, R_KEY_COPY + 2, R_KEY_COPY + 9),
                fx.cat1([fx.cols(nxt, R_KEY_COPY + 9, R_KEY_COPY + 12),
                         fx.col(nxt, DELTA_COPY)[None],
                         fx.col(nxt, NONCE_COPY)[None],
                         fx.zeros_like(fx.cols(nxt, 0, 2))])]
        for k in range(4):
            term = fx.mul(srcs[k], internal_flags[k])
            internal = term if internal is None else fx.add(internal, term)

        SC.evaluate_schnorr(fx, current, nxt, agg, ark0, ark1, doubling,
                            addition, digest_flags, pkey, final_flag,
                            schnorr_hash, copy_hash, internal, gen12, b3)

        # 6. range proofs on delta and sigma (air.rs:585-609)
        for acc_pos, bit_pos in ((DELTA_ACC, DELTA_BIT),
                                 (SIGMA_ACC, SIGMA_BIT)):
            c_acc, c_bit = double_and_add(fx, fx.col(current, acc_pos),
                                          fx.col(nxt, acc_pos),
                                          fx.col(nxt, bit_pos))
            agg(acc_pos, fx.mul(c_acc, range_step[0]))
            agg(bit_pos, fx.mul(c_bit, range_step[0]))
        # endpoint equalities, the reference's sigma bug replicated: both
        # compare the DELTA registers (air.rs:605-609)
        delta_eq = fx.sub(fx.col(nxt, DELTA_ACC), fx.col(nxt, DELTA_COPY))
        agg(DELTA_RANGE_RES, fx.mul(delta_eq, range_finish[0]))
        agg(SIGMA_RANGE_RES, fx.mul(delta_eq, range_finish[0]))

        return fx.stack(res)

    def assertions(self):
        last = self.trace_length - 1
        # reference quirk: only root elements 0 and 1 are asserted
        return [Assertion(MU.PREV_ROOT, 0, self.initial_root[0]),
                Assertion(MU.PREV_ROOT + 1, 0, self.initial_root[1]),
                Assertion(MU.PREV_ROOT, last, self.final_root[0]),
                Assertion(MU.PREV_ROOT + 1, last, self.final_root[1])]


class TransactionExample:
    """Mirrors the reference's crate-root TransactionExample
    (src/lib.rs:75-162): the witness (account tree, transactions,
    signatures) is built on the host in __init__; `trace` builds the
    Montgomery trace [94, 1024*T] on the device. Runs on the card unless
    `device` names another."""

    def __init__(self, num_transactions: int, options, depth: int = 15,
                 seed: int = 42, device=None):
        from ..utils import witness as W
        self.options = options
        self.depth = depth
        self.device = DV.resolve(device)
        self.md = W.build_random(num_transactions, depth, seed,
                                 with_signatures=True)
        self.messages = [
            W.build_tx_message(self.md.s_old_values[i][:12],
                               self.md.r_old_values[i][:12],
                               self.md.deltas[i], self.md.s_old_values[i][13])
            for i in range(num_transactions)]

    @property
    def trace(self):
        """Built on demand, not cached (94 x 1024T x 8 bytes)."""
        from .trace_device import build_trace
        return build_trace(self.md, self.messages, self.device)

    def pub_inputs(self):
        return (list(self.md.initial_roots[0]), list(self.md.final_root))

    def air(self):
        return TransactionAir(CYCLE * len(self.md.deltas), self.pub_inputs(),
                              self.options, depth=self.depth)

    def prove(self):
        return Prover(self.air(), self.device).prove(self.trace)

    def verify(self, proof, pub_inputs=None):
        """The port's verifier on the host, with this example's options and
        depth."""
        from ..engine import verifier as V
        return V.verify(TransactionAir, proof, pub_inputs or self.pub_inputs(),
                        air_kwargs={"depth": self.depth},
                        expected_options=self.options)
