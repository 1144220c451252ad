"""AIR (algebraic intermediate representation) framework.

Counterpart of certificate_stark_tpu/engine/air.py: transition constraints
with declared degrees, periodic columns and boundary assertions.
`evaluate_transition` is a batch evaluation over all domain points at once
on int64 tensors [width, B].
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import field as F, ntt as NTT


@dataclass(frozen=True)
class Assertion:
    """T_column(step) == value  (winterfell Assertion::single)."""
    column: int
    step: int
    value: int


@dataclass(frozen=True)
class PeriodicAssertion:
    """T_column(first_step + i*period) == value for all i."""
    column: int
    first_step: int
    period: int
    value: int


@dataclass(frozen=True)
class SequenceAssertion:
    """T_column(first_step + i*period) == values[i]."""
    column: int
    first_step: int
    period: int
    values: tuple


@dataclass(frozen=True)
class ConstraintDegree:
    """`mult` in the trace polynomials plus one periodic factor per entry of
    `cycles` (winterfell TransitionConstraintDegree::with_cycles)."""
    mult: int
    cycles: tuple = ()

    def poly_degree(self, n: int) -> int:
        d = self.mult * (n - 1)
        for c in self.cycles:
            d += n - n // c
        return d


class Air:
    """Subclass per proof statement. Override the marked members."""

    trace_width: int = 0
    name: str = "air"

    def __init__(self, trace_length: int, pub_inputs, options):
        assert trace_length & (trace_length - 1) == 0
        self.trace_length = trace_length
        self.pub_inputs = pub_inputs
        self.options = options

    # -- to override --------------------------------------------------------
    def transition_degrees(self) -> list:
        raise NotImplementedError

    def periodic_columns(self):
        """Int matrix [n_cols, cycle_length] of periodic values, or None."""
        return None

    def evaluate_transition(self, fx, current, nxt, periodic):
        """Constraint evaluations [C, B] from frames current/nxt [w, B] and
        periodic columns [P, B]."""
        raise NotImplementedError

    def assertions(self) -> list:
        raise NotImplementedError

    def pub_inputs_elements(self) -> list:
        """Field elements absorbed into the Fiat-Shamir seed (flattened)."""
        out = []

        def rec(x):
            if isinstance(x, (list, tuple)):
                for y in x:
                    rec(y)
            elif isinstance(x, np.ndarray):
                for y in x.ravel():
                    rec(y)
            else:
                out.append(int(x))

        rec(self.pub_inputs)
        return out

    # -- provided -----------------------------------------------------------
    def ce_blowup(self) -> int:
        """Constraint-evaluation domain blowup k: composition degree = k*n."""
        n = self.trace_length
        k = 1
        for d in self.transition_degrees():
            qd = d.poly_degree(n) - (n - 1)   # after the transition zerofier
            while qd + 1 > k * n:
                k *= 2
        assert k <= self.options.blowup, (
            f"constraint degree needs ce blowup {k} > lde blowup "
            f"{self.options.blowup}")
        return k

    def periodic_lde(self, blowup: int, offset: int, device):
        """Periodic columns extended to the LDE domain, compact form:
        [n_cols, L] Montgomery with L = blowup * lcm(cycle lengths). Column
        poly p(x^(n/t)) has period blowup*t on the coset, so one block
        carries the whole LDE; consumers tile it. The columns of one cycle
        length go through the device NTT together (canonical values: the
        same bits as the JAX package's host NTTs)."""
        cols = self.periodic_columns()
        if cols is None:
            return None
        n = self.trace_length
        lcm = 1
        for col in cols:
            lcm = lcm * len(col) // math.gcd(lcm, len(col))
        rows = [None] * len(cols)
        for t in sorted({len(col) for col in cols}):
            idx = [i for i, col in enumerate(cols) if len(col) == t]
            vals = F.from_ints([[int(v) % F.P for v in cols[i]] for i in idx],
                               device)
            ext = NTT.lde(vals, blowup, pow(offset, n // t, F.P))
            for i, row in zip(idx, ext.repeat(1, lcm // t)):
                rows[i] = row
        return torch.stack(rows)


def tile_periodic(block: torch.Tensor, length: int) -> torch.Tensor:
    """Tile a compact periodic block [P, L] to `length` domain points."""
    assert length % block.shape[-1] == 0
    return block.repeat(1, length // block.shape[-1])
