"""Rescue hash-chain AIR: the reference's benchmark workload
(benches/rescue.rs). Prove knowledge of a chain of `length` Rescue63 merges
from a public seed to a public result: d_{i+1} = permutation([d_i, 0])[0..7].
Trace 14 wide, 8 rows per link (7 rounds and a copy step).

Counterpart of certificate_stark_tpu/models/rescue_chain.py. The trace is
built on the host in Python ints (the chain is sequential) and moved to the
device in Montgomery form; a device trace kernel is later work.
"""
from __future__ import annotations

import torch

from ..engine.air import Air, Assertion, ConstraintDegree
from ..engine.prover import Prover
from ..ops import field as F, rescue as R
from ..params import data as D
from ..utils import device as DV, rescue_ref as RR
from .constraints import rescue_enforce_round

TRACE_WIDTH = 14
CYCLE = R.CYCLE_LENGTH  # 8
SEED = [42, 43, 44, 45, 46, 47, 48]


def trace_rows(seed, chain_length: int) -> list:
    """Standard-form trace rows: per link the states [d || 0], round 1..7."""
    d = [int(x) % F.P for x in seed]
    rows = []
    for _ in range(chain_length):
        state = d + [0] * 7
        rows.append(state)
        for r in range(R.NUM_ROUNDS):
            state = RR.apply_round(state, r)
            rows.append(state)
        d = state[:7]
    return rows


def build_trace(seed, chain_length: int, device=None) -> torch.Tensor:
    """Montgomery trace [14, 8*chain_length] (int64) on `device`."""
    assert chain_length & (chain_length - 1) == 0
    device = DV.resolve(device)
    std = torch.tensor(trace_rows(seed, chain_length), dtype=torch.int64)
    return F.to_mont(std.T.contiguous().to(device))


def compute_chain_result(seed, chain_length: int) -> list:
    """The public result: the first 7 elements of the last row."""
    return trace_rows(seed, chain_length)[-1][:7]


class RescueChainAir(Air):
    """Public inputs: (seed[7], result[7])."""

    name = "rescue-chain"
    trace_width = TRACE_WIDTH

    def __init__(self, trace_length, pub_inputs, options):
        super().__init__(trace_length, pub_inputs, options)
        self.seed = [int(x) for x in pub_inputs[0]]
        self.result = [int(x) for x in pub_inputs[1]]

    def transition_degrees(self):
        return [ConstraintDegree(3, (CYCLE,)) for _ in range(TRACE_WIDTH)]

    def periodic_columns(self):
        # column 0: round flag (1 on rounds, 0 on the copy step);
        # columns 1..28: ARK columns, 8th row zero
        cols = [[1] * 7 + [0]]
        for j in range(2 * R.STATE_WIDTH):
            cols.append([D.RESCUE_ARK[i][j] for i in range(CYCLE)])
        return cols

    def evaluate_transition(self, fx, current, nxt, periodic):
        flag = fx.col(periodic, 0)                 # [B]
        ark0 = fx.cols(periodic, 1, 15)            # [14, B]
        ark1 = fx.cols(periodic, 15, 29)

        round_c = rescue_enforce_round(fx, current, nxt, ark0, ark1)

        copy_c = fx.cat1([
            fx.sub(fx.cols(nxt, 0, 7), fx.cols(current, 0, 7)),
            fx.cols(nxt, 7, 14),
        ])
        return fx.add(fx.mul(round_c, flag[None]),
                      fx.mul(copy_c, fx.one_mask(flag)[None]))  # [14, B]

    def assertions(self):
        last = self.trace_length - 1
        return ([Assertion(i, 0, self.seed[i]) for i in range(7)]
                + [Assertion(i, last, self.result[i]) for i in range(7)])


class RescueChainExample:
    """Build the trace and public inputs, then prove and verify, as the
    reference's example does. Proves on the card unless `device` names
    another."""

    def __init__(self, chain_length: int, options, device=None):
        self.chain_length = chain_length
        self.options = options
        self.device = DV.resolve(device)
        self.seed = list(SEED)
        self.trace = build_trace(self.seed, chain_length, self.device)
        self.result = [int(v) for v in F.to_ints(self.trace[:7, -1])]

    def pub_inputs(self):
        return (self.seed, self.result)

    def air(self):
        return RescueChainAir(self.chain_length * CYCLE, self.pub_inputs(),
                              self.options)

    def prove(self):
        return Prover(self.air(), self.device).prove(self.trace)

    def verify(self, proof, pub_inputs=None):
        """The port's verifier on the host, with this example's options."""
        from ..engine import verifier as V
        return V.verify(RescueChainAir, proof, pub_inputs or self.pub_inputs(),
                        expected_options=self.options)
