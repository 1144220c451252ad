"""Pre-Merkle (leaf initialization) sub-AIR — reference src/merkle/init/:
four parallel Rescue states hash (pk || balance || nonce) for the old/new
sender and receiver leaves. Width 58, trace length 16 (one transaction cycle).
Counterpart of certificate_stark_tpu/models/merkle_init.py.

Quirks replicated from the reference:
  * trace init writes the sender-initial coins/nonce into the *updated* state
    slots before overwriting them (init/trace.rs:27-31), leaving
    SENDER_INITIAL[12..14] zero — masked upstream because the standalone
    example uses all-zero inputs (init/mod.rs:69-71); we do the same.
  * the round function applies at every step with ark[step % 8], i.e. the
    8th "round" uses the all-zero ark row (trace.rs:57-75 + rescue.rs ARK).
  * constraint indices are compacted by -0/-1/-1/-2 shifts (init/air.rs:166-198),
    yielding 56 contiguous degree-3 constraints.
"""
from __future__ import annotations

import torch

from ..engine.air import Air, Assertion, ConstraintDegree
from ..engine.prover import Prover
from ..ops import field as F, rescue as R
from ..params import data as D
from ..utils import device as DV
from .constraints import rescue_enforce_round

HASH_STATE_WIDTH = 14
AFFINE_POINT_WIDTH = 12
TRACE_WIDTH = 4 * HASH_STATE_WIDTH + 2  # 58
CYCLE = 16

SENDER_INITIAL_POS = 0
SENDER_BIT_POS = 14
SENDER_UPDATED_POS = 15
RECEIVER_INITIAL_POS = 29
RECEIVER_BIT_POS = 43
RECEIVER_UPDATED_POS = 44

_STATE_POS = [SENDER_INITIAL_POS, SENDER_UPDATED_POS,
              RECEIVER_INITIAL_POS, RECEIVER_UPDATED_POS]


def init_row(s_inputs, r_inputs, delta):
    """First trace row as ints (mirrors init/trace.rs:18-52, incl. quirk)."""
    state = [0] * TRACE_WIDTH
    state[SENDER_INITIAL_POS:SENDER_INITIAL_POS + 12] = s_inputs[:12]
    state[SENDER_UPDATED_POS + 12] = s_inputs[12]
    state[SENDER_UPDATED_POS + 13] = s_inputs[13]
    state[SENDER_UPDATED_POS:SENDER_UPDATED_POS + 12] = s_inputs[:12]
    state[SENDER_UPDATED_POS + 12] = (s_inputs[12] - delta) % F.P
    state[SENDER_UPDATED_POS + 13] = (s_inputs[13] + 1) % F.P
    state[RECEIVER_INITIAL_POS:RECEIVER_INITIAL_POS + 12] = r_inputs[:12]
    state[RECEIVER_INITIAL_POS + 12] = r_inputs[12]
    state[RECEIVER_INITIAL_POS + 13] = r_inputs[13]
    state[RECEIVER_UPDATED_POS:RECEIVER_UPDATED_POS + 12] = r_inputs[:12]
    state[RECEIVER_UPDATED_POS + 12] = (r_inputs[12] + delta) % F.P
    state[RECEIVER_UPDATED_POS + 13] = r_inputs[13]
    return [v % F.P for v in state]


def build_trace(s_inputs, r_inputs, delta, device=None) -> torch.Tensor:
    """Montgomery trace [58, 16] on `device`: the four states advance
    together, one Rescue round a step (ops/rescue.py `apply_round`)."""
    device = DV.resolve(device)
    st = F.from_ints(init_row(s_inputs, r_inputs, delta), device)
    rows = [st]
    for step in range(CYCLE - 1):
        st = st.clone()
        states = torch.stack([st[p:p + 14] for p in _STATE_POS], dim=1)
        states = R.apply_round(states, step)                 # [14, 4]
        for i, p in enumerate(_STATE_POS):
            st[p:p + 14] = states[:, i]
        rows.append(st)
    return torch.stack(rows, dim=1)


class MerkleInitAir(Air):
    """Public inputs: (s_inputs[14], r_inputs[14], delta)."""

    name = "merkle-init"
    trace_width = TRACE_WIDTH

    def __init__(self, trace_length, pub_inputs, options):
        super().__init__(trace_length, pub_inputs, options)
        self.s_inputs = [int(x) % F.P for x in pub_inputs[0]]
        self.r_inputs = [int(x) % F.P for x in pub_inputs[1]]
        self.delta = int(pub_inputs[2]) % F.P

    def transition_degrees(self):
        return [ConstraintDegree(3) for _ in range(56)]

    def periodic_columns(self):
        return [[D.RESCUE_ARK[i][j] for i in range(R.CYCLE_LENGTH)]
                for j in range(2 * R.STATE_WIDTH)]

    def evaluate_transition(self, fx, current, nxt, periodic):
        ark0 = fx.cols(periodic, 0, 14)
        ark1 = fx.cols(periodic, 14, 28)
        return fx.cat1([rescue_enforce_round(
            fx, fx.cols(current, pos, pos + 14), fx.cols(nxt, pos, pos + 14),
            ark0, ark1) for pos in _STATE_POS])                # [56, B]

    def assertions(self):
        s, r, delta = self.s_inputs, self.r_inputs, self.delta
        out = [Assertion(SENDER_INITIAL_POS + i, 0, s[i]) for i in range(14)]
        out += [Assertion(SENDER_UPDATED_POS + i, 0, s[i]) for i in range(12)]
        out.append(Assertion(SENDER_UPDATED_POS + 12, 0, (s[12] - delta) % F.P))
        out.append(Assertion(SENDER_UPDATED_POS + 13, 0, (s[13] + 1) % F.P))
        out += [Assertion(RECEIVER_INITIAL_POS + i, 0, r[i]) for i in range(14)]
        out += [Assertion(RECEIVER_UPDATED_POS + i, 0, r[i]) for i in range(12)]
        out.append(Assertion(RECEIVER_UPDATED_POS + 12, 0,
                             (r[12] + delta) % F.P))
        out.append(Assertion(RECEIVER_UPDATED_POS + 13, 0, r[13]))
        return out


class MerkleInitExample:
    """Mirrors init/mod.rs PreMerkleExample (all-zero inputs, delta=1).
    Runs on the card unless `device` names another."""

    def __init__(self, options, device=None):
        self.options = options
        self.device = DV.resolve(device)
        self.s_inputs = [0] * 14
        self.r_inputs = [0] * 14
        self.delta = 1

    @property
    def trace(self):
        """Built on demand, not cached."""
        return build_trace(self.s_inputs, self.r_inputs, self.delta,
                           self.device)

    def pub_inputs(self):
        return (self.s_inputs, self.r_inputs, self.delta)

    def air(self):
        return MerkleInitAir(CYCLE, self.pub_inputs(), self.options)

    def prove(self):
        return Prover(self.air(), self.device).prove(self.trace)

    def verify(self, proof, pub_inputs=None):
        """The port's verifier on the host, with this example's options."""
        from ..engine import verifier as V
        return V.verify(MerkleInitAir, proof, pub_inputs or self.pub_inputs(),
                        expected_options=self.options)
