"""Schnorr signature-verification sub-AIR — reference src/schnorr/.
Counterpart of certificate_stark_tpu/models/schnorr.py; its constants, host
trace steps and constraint block also serve the composed state-transition
AIR.

It proves a batch of R = s*G + h*P with h the iterated Rescue hash of
(R_x || message). Trace 56 wide, 512 steps a signature:

  cols 0..18  projective accumulator S = s*G     col 18  s-bit
  cols 19..37 projective accumulator h*P         col 37  h-bit
  cols 38..42 h-limb double-and-add accumulators (chunk 3..0 at 38..41)
  cols 42..56 Rescue hash state (digest 42..49, rate 49..56)

Steps 0..509: interleaved double (even) / conditional mixed add (odd) for
both scalar multiplications and the h-bit recomposition, with the 5-cycle
message hash in steps 0..39. Step 510: S + h*P with affine-x reduction.

Public keys and message chunks enter as full-trace-length periodic columns
(schnorr/air.rs:229-299).
"""
from __future__ import annotations

from ..engine.air import (Air, ConstraintDegree, PeriodicAssertion,
                          SequenceAssertion)
from ..engine.prover import Prover
from ..ops import ecc as E, rescue as R
from ..params import data as D
from ..params.data import P
from ..utils import curve as CV, device as DV, ecc_ref as ER, rescue_ref as RR
from .constraints import rescue_enforce_round

TRACE_WIDTH = 56
SIG_CYCLE = 512
SCALAR_MUL_LENGTH = 510
NUM_HASH_ITER = 5
PPW, PCW, APW = 18, 6, 12


def _gen12():
    return list(CV.GEN12)


def scalar_digits() -> int:
    """Base-p digits needed to represent any scalar < the active curve's
    group order (fp2 instance: 4; subfield: 3). Fixed per curve so the
    pub-inputs element count — hence transcript layout and proof bytes —
    is deterministic."""
    nd, cap = 1, P
    while cap < CV.SCALAR_Q:
        nd += 1
        cap *= P
    return nd


def build_sig_info(message28, signature):
    """(pkey12, s_bits, h_bits) for trace generation
    (schnorr/trace.rs:127-142)."""
    r_x, s = signature
    pkey12 = [int(v) % P for v in message28[:12]]
    s_bits = [(int(s) >> i) & 1 for i in range(256)]
    h_bits = CV.h_to_scalar_bits(CV.hash_message(list(r_x), message28))
    return pkey12, s_bits, h_bits


def init_sig_state(row, r_x):
    """Schnorr start state written into row[0:56] (schnorr/trace.rs:18-30)."""
    row[0:TRACE_WIDTH] = [0] * TRACE_WIDTH
    row[PCW] = 1                      # y(S) = 1
    row[PPW + 1 + PCW] = 1            # y(h.P) = 1
    row[42:48] = [int(v) % P for v in r_x]


def sig_step(row, step, message28, pkey12, s_bits, h_bits, gen12):
    """One Schnorr transition applied in place to row[0:56]
    (schnorr/trace.rs:35-122); `step` is signature-relative."""
    if step < 8 * NUM_HASH_ITER:
        rs = step % 8
        if rs < 7:
            row[42:56] = RR.apply_round(row[42:56], step)
        elif step < (NUM_HASH_ITER - 1) * 8:
            idx = step // 8
            row[49:56] = [int(v) % P for v in message28[7 * idx:7 * idx + 7]]
        else:
            row[49:56] = [0] * 7
    if step < SCALAR_MUL_LENGTH:
        real = step // 2
        chunk = 0 if real < 63 else (real - 63) // 64 + 1
        row[PPW] = s_bits[254 - real]
        row[2 * PPW + 1] = h_bits[254 - real]
        if step % 2 == 0:
            row[0:18] = ER.compute_double(row[0:18])
            row[19:37] = ER.compute_double(row[19:37])
            vp = 41 - chunk
            row[vp] = (2 * row[vp] + row[37]) % P
        else:
            if row[PPW] == 1:
                row[0:18] = ER.compute_add_mixed(row[0:18], gen12)
            if row[2 * PPW + 1] == 1:
                row[19:37] = ER.compute_add_mixed(row[19:37], pkey12)
    elif step == SCALAR_MUL_LENGTH:
        hp = list(row[19:37])
        row[PPW] = 1
        row[0:18] = ER.compute_add(row[0:18], hp)
        row[0:6] = ER.to_affine_x(row[0:18])


def sig_rows(message28, signature):
    """One signature's 512 trace rows (host ints; schnorr/trace.rs:18-122):
    the host reference of `build_trace`."""
    pkey12, s_bits, h_bits = build_sig_info(message28, signature)
    gen12 = _gen12()
    row = [0] * TRACE_WIDTH
    init_sig_state(row, signature[0])
    rows = [list(row)]
    for step in range(SIG_CYCLE - 1):
        row = list(row)
        sig_step(row, step, message28, pkey12, s_bits, h_bits, gen12)
        rows.append(row)
    return rows


def build_trace(messages, signatures, device=None):
    """The Montgomery trace [56, 512*len(signatures)] on `device`, built by
    the composed AIR's trace kernel (models/trace_device.py
    `build_trace_sig`)."""
    from .trace_device import build_trace_sig
    return build_trace_sig(messages, signatures, DV.resolve(device))


def evaluate_schnorr(fx, current, nxt, agg, ark0, ark1, doubling, addition,
                     digest_flags, pkey, final_flag, hash_flag, copy_hash,
                     internal, gen12=None, b3=None):
    """Schnorr constraint block (schnorr/air.rs:394-531), aggregating into
    result slots 0..56 via `agg`. The flags are [1, B]; pkey [12, B] and
    internal [7, B] come from the composed AIR's copy registers. gen12 and
    b3 (standard-form ints) default to the active curve's."""
    one = fx.const(1, current)
    b3 = CV.B3_LIMBS if b3 is None else b3
    gen12 = fx.embed(_gen12() if gen12 is None else gen12, current)

    # the two scalar multiplications (S = s*G and h*P) run the same
    # doubling and conditional-add constraints: one EC block on [2, 19, B]
    cur12 = fx.stack([fx.cols(current, 0, 19), fx.cols(current, 19, 38)])
    nxt12 = fx.stack([fx.cols(nxt, 0, 19), fx.cols(nxt, 19, 38)])
    pts12 = fx.stack([fx.expand(gen12, pkey), pkey])
    dflag = doubling[None]
    aflag = addition[None]
    dbl12 = E.enforce_point_doubling(fx, cur12, nxt12, dflag, b3)
    addm12 = E.enforce_point_addition_mixed(fx, cur12, nxt12, pts12, aflag, b3)
    red = E.enforce_point_addition_reduce_x(
        fx, fx.cols(current, 0, 18), fx.cols(nxt, 0, 18),
        fx.cols(current, 19, 37), final_flag, b3)
    for i in range(19):
        agg(i, fx.add(dbl12[0, i], addm12[0, i]))
        agg(19 + i, fx.add(dbl12[1, i], addm12[1, i]))
    for i in range(18):
        agg(i, red[i])

    # h-limb accumulators (rows 38..42)
    hbit = fx.col(nxt, 37)
    for i, dflag in enumerate(digest_flags):
        vp = 41 - i
        acc = fx.sub(fx.col(nxt, vp),
                     fx.add(fx.double(fx.col(current, vp)), hbit))
        agg(vp, fx.mul(acc, fx.mul(dflag, doubling)[0]))
        # copy outside its double-and-add window
        cp = fx.sub(fx.col(current, vp), fx.col(nxt, vp))
        agg(vp, fx.mul(cp, fx.mul(fx.sub(one, dflag), doubling)[0]))
    for i in range(4):
        cp = fx.sub(fx.col(current, 38 + i), fx.col(nxt, 38 + i))
        agg(38 + i, fx.mul(cp, addition[0]))
        eq = fx.sub(fx.col(current, 38 + i), fx.col(current, 42 + i))
        agg(38 + i, fx.mul(eq, final_flag[0]))

    # hash rows (42..56)
    hcur = fx.cols(current, 42, 56)
    hnxt = fx.cols(nxt, 42, 56)
    round_c = fx.mul(rescue_enforce_round(fx, hcur, hnxt, ark0, ark1),
                     hash_flag)
    cp7 = fx.mul(fx.sub(fx.cols(current, 42, 49), fx.cols(nxt, 42, 49)),
                 copy_hash)
    rate = fx.mul(fx.sub(fx.cols(nxt, 49, 56), internal), copy_hash)
    for i in range(14):
        agg(42 + i, round_c[i])
    for i in range(7):
        agg(42 + i, cp7[i])
        agg(49 + i, rate[i])


class SchnorrAir(Air):
    """Public inputs: (messages list of 28-el lists, signatures list of
    (r_x 6-el, s int))."""

    name = "schnorr"
    trace_width = TRACE_WIDTH

    def __init__(self, trace_length, pub_inputs, options):
        super().__init__(trace_length, pub_inputs, options)
        self.messages = [[int(v) % P for v in m] for m in pub_inputs[0]]
        self.signatures = [(list(map(int, rx)), int(s))
                           for rx, s in pub_inputs[1]]

    def pub_inputs_elements(self):
        # The signature scalar s is bound to the transcript as FULL base-p
        # digits, enough to cover the active curve's scalar order
        # injectively (4 for the fp2 instance, 3 for the subfield one);
        # each digit is < p, so absorption and serialization are lossless
        # (src/schnorr/mod.rs:217, src/schnorr/air.rs:31-39).
        nd = scalar_digits()
        out = []
        for m, (rx, s) in zip(self.messages, self.signatures):
            out.extend(m)
            out.extend(rx)
            for _ in range(nd):
                out.append(s % P)
                s //= P
            assert s == 0, "scalar exceeds the active curve's digit budget"
        return out

    def transition_degrees(self):
        c = (SIG_CYCLE,)
        cc = (SIG_CYCLE, SIG_CYCLE)
        pk_extra = 0 if len(self.signatures) == 1 else 1
        deg = []
        deg += [ConstraintDegree(5, cc)] * PCW                 # x(S) rows
        deg += [ConstraintDegree(4, cc)] * APW                 # y,z (S)
        deg += [ConstraintDegree(2, c)]                        # s bit
        deg += [ConstraintDegree(4 + pk_extra, cc)] * PPW      # h.P rows
        deg += [ConstraintDegree(2, c)]                        # h bit
        deg += [ConstraintDegree(1, cc)] * 4                   # h accumulators
        deg += [ConstraintDegree(3, c)] * 14                   # hash rows
        return deg

    def periodic_columns(self):
        nsig = len(self.signatures)
        full = SIG_CYCLE * nsig
        tail = SIG_CYCLE - SCALAR_MUL_LENGTH
        global_mask = [1] * (SCALAR_MUL_LENGTH + 1) + [0] * (tail - 1)
        scalar_flag = [1] * SCALAR_MUL_LENGTH + [0] * tail
        doubling = [1, 0] * (SCALAR_MUL_LENGTH // 2) + [0] * tail
        digest_flags = [[0] * SIG_CYCLE for _ in range(4)]
        digest_flags[0][0:126] = [1] * 126
        digest_flags[1][126:254] = [1] * 128
        digest_flags[2][254:382] = [1] * 128
        digest_flags[3][382:510] = [1] * 128
        hash_flag = ([1] * 7 + [0]) * NUM_HASH_ITER
        hash_flag += [0] * (SIG_CYCLE - len(hash_flag))
        pkeys = [[self.messages[k][j] for k in range(nsig)
                  for _ in range(SIG_CYCLE)] for j in range(APW)]
        # message chunks injected at the end of hash cycles 0..3
        internal = [[0] * full for _ in range(7)]
        for k in range(nsig):
            for it in range(NUM_HASH_ITER - 1):
                for j in range(7):
                    internal[j][k * SIG_CYCLE + it * 8 + 7] = \
                        self.messages[k][7 * it + j]
        cols = ([global_mask, scalar_flag, doubling] + digest_flags
                + pkeys + [hash_flag] + internal)
        for j in range(2 * R.STATE_WIDTH):
            cols.append([D.RESCUE_ARK[i][j] for i in range(R.CYCLE_LENGTH)])
        return cols

    def evaluate_transition(self, fx, current, nxt, periodic):
        def flag(i):                                   # [1, B]
            return fx.col(periodic, i)[None]
        pk_base = 7
        global_mask, scalar_flag, doubling = flag(0), flag(1), flag(2)
        digest_flags = [flag(3 + i) for i in range(4)]
        pkey = fx.cols(periodic, pk_base, pk_base + APW)
        hash_flag = flag(pk_base + APW)
        internal = fx.cols(periodic, pk_base + APW + 1, pk_base + APW + 8)
        ark0 = fx.cols(periodic, pk_base + APW + 8, pk_base + APW + 22)
        ark1 = fx.cols(periodic, pk_base + APW + 22, pk_base + APW + 36)

        one = fx.const(1, current)
        copy_hash = fx.mul(fx.sub(one, hash_flag), global_mask)
        final_flag = fx.mul(fx.sub(one, scalar_flag), global_mask)
        addition = fx.mul(fx.sub(one, doubling), scalar_flag)

        res = [None] * TRACE_WIDTH

        def agg(idx, val):
            res[idx] = val if res[idx] is None else fx.add(res[idx], val)

        evaluate_schnorr(fx, current, nxt, agg, ark0, ark1, doubling,
                         addition, digest_flags, pkey, final_flag, hash_flag,
                         copy_hash, internal)
        return fx.stack(res)

    def assertions(self):
        sigs = self.signatures
        out = []
        for i in range(19):
            out.append(PeriodicAssertion(i, 0, SIG_CYCLE,
                                         1 if i == PCW else 0))
        for i in range(PPW):
            out.append(PeriodicAssertion(19 + i, 0, SIG_CYCLE,
                                         1 if i == PCW else 0))
        for i in range(5):
            out.append(PeriodicAssertion(37 + i, 0, SIG_CYCLE, 0))
        for j in range(6):
            out.append(SequenceAssertion(42 + j, 0, SIG_CYCLE,
                                         tuple(int(s[0][j]) for s in sigs)))
        for i in range(7):
            out.append(PeriodicAssertion(48 + i, 0, SIG_CYCLE, 0))
        for j in range(6):
            out.append(SequenceAssertion(j, SCALAR_MUL_LENGTH + 1, SIG_CYCLE,
                                         tuple(int(s[0][j]) for s in sigs)))
        return out


class SchnorrExample:
    """Mirrors schnorr/mod.rs SchnorrExample: random keys and messages,
    signed and checked on the host in __init__ (the rng draws skey, 14
    message values, then sign's r, per signature); `trace` builds the
    trace on the device. Runs on the card unless `device` names another."""

    def __init__(self, num_signatures: int, options, seed: int = 5,
                 device=None):
        import random
        rng = random.Random(seed)
        self.options = options
        self.device = DV.resolve(device)
        self.messages = []
        self.signatures = []
        for _ in range(num_signatures):
            skey = rng.randrange(1, CV.SCALAR_Q)
            pk = CV.pkey_coords(skey)
            msg = (pk + [rng.randrange(P) for _ in range(14)] + [0, 0])[:28]
            sig = CV.sign(msg, skey, rng)
            assert CV.verify_signature(msg, sig)
            self.messages.append(msg)
            self.signatures.append(sig)

    @property
    def trace(self):
        """Built on demand, not cached."""
        return build_trace(self.messages, self.signatures, self.device)

    def pub_inputs(self):
        return (self.messages, self.signatures)

    def air(self):
        return SchnorrAir(SIG_CYCLE * len(self.signatures), self.pub_inputs(),
                          self.options)

    def prove(self):
        return Prover(self.air(), self.device).prove(self.trace)

    def verify(self, proof, pub_inputs=None):
        """The port's verifier on the host, with this example's options."""
        from ..engine import verifier as V
        return V.verify(SchnorrAir, proof, pub_inputs or self.pub_inputs(),
                        expected_options=self.options)
