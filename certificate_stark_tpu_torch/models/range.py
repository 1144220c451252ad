"""64-bit range-proof AIR (reference: src/range/): prove that a public field
element decomposes into 63 bits accumulated by double-and-add.
Counterpart of certificate_stark_tpu/models/range.py.

Trace (2 x 64, src/range/prover.rs:65-90): col 0 = bit, col 1 = accumulator;
row 0 = (0, 0); row t+1 carries number-bit[62-t] and acc' = 2*acc + bit'.
Constraints (src/range/air.rs:91-105 + src/utils/field.rs:31-50):
  c0 = is_binary(next.bit), c1 = next.acc - (2*current.acc + next.bit).
Assertions: acc(0) = 0, acc(last) = number.
"""
from __future__ import annotations

import torch

from ..engine.air import Air, Assertion, ConstraintDegree
from ..engine.prover import Prover
from ..ops import field as F
from ..utils import device as DV
from .constraints import double_and_add

TRACE_WIDTH = 2
RANGE_LOG = 64


def trace_rows(number: int) -> list:
    """The two standard-form trace columns [bit, acc] as host ints."""
    number = int(number)
    if not 0 <= number < F.P:
        # reference parity: field construction panics on value >= modulus and
        # on negative inputs under debug (src/range/tests.rs:54-73)
        raise ValueError(f"range input {number} outside the field [0, p)")
    col_bit, col_acc = [0], [0]
    for t in range(RANGE_LOG - 1):
        b = (number >> (RANGE_LOG - 2 - t)) & 1
        col_bit.append(b)
        col_acc.append((2 * col_acc[-1] + b) % F.P)
    return [col_bit, col_acc]


def build_trace(number: int, device=None) -> torch.Tensor:
    """Montgomery trace [2, 64] (int64) on `device`."""
    rows = trace_rows(number)
    return F.from_ints(rows, DV.resolve(device))


class RangeAir(Air):
    """Public input: the number."""

    name = "range"
    trace_width = TRACE_WIDTH

    def __init__(self, trace_length, pub_inputs, options):
        super().__init__(trace_length, pub_inputs, options)
        self.number = int(list(pub_inputs)[0]) % F.P

    def transition_degrees(self):
        return [ConstraintDegree(2), ConstraintDegree(1)]

    def evaluate_transition(self, fx, current, nxt, periodic):
        c_acc, c_bit = double_and_add(fx, fx.col(current, 1), fx.col(nxt, 1),
                                      fx.col(nxt, 0))
        return fx.stack([c_bit, c_acc])

    def assertions(self):
        return [Assertion(1, 0, 0),
                Assertion(1, self.trace_length - 1, self.number)]


class RangeExample:
    """Mirrors src/range/mod.rs RangeProofExample. Runs on the card unless
    `device` names another."""

    def __init__(self, number: int, options, device=None):
        self.number = int(number)
        self.options = options
        self.device = DV.resolve(device)
        trace_rows(self.number)  # validates 0 <= number < p

    @property
    def trace(self):
        """Built on demand, not cached."""
        return build_trace(self.number, self.device)

    def pub_inputs(self):
        return [self.number]

    def air(self):
        return RangeAir(RANGE_LOG, self.pub_inputs(), self.options)

    def prove(self):
        # the trace is rebuilt inside prove, as the reference's prove does
        return Prover(self.air(), self.device).prove(self.trace)

    def verify(self, proof, number=None):
        """The port's verifier on the host, with this example's options."""
        from ..engine import verifier as V
        return V.verify(RangeAir, proof,
                        [self.number if number is None else number],
                        expected_options=self.options)
