"""Field-ops facade that AIR constraint code is written against.

Counterpart of the base-field `BaseFieldOps` of
certificate_stark_tpu/engine/fieldops.py. Elements are int64 tensors
[*S] (Montgomery); a frame is [w, B], and `col`/`cols` select along the
leading column axis.
"""
from __future__ import annotations

import torch

from ..ops import field as F, rescue as R


class BaseFieldOps:
    degree = 1

    add = staticmethod(F.add)
    sub = staticmethod(F.sub)
    mul = staticmethod(F.mul)
    square = staticmethod(F.square)
    neg = staticmethod(F.neg)
    double = staticmethod(F.double)
    inv = staticmethod(F.inv)

    @staticmethod
    def col(arr, i):
        """Trace column i of a frame [w, B] -> [B]."""
        return arr[i]

    @staticmethod
    def cols(arr, lo, hi):
        return arr[lo:hi]

    @staticmethod
    def cat1(parts):
        """Concatenate along the column/constraint axis."""
        return torch.cat(parts, dim=0)

    @staticmethod
    def one_mask(mask_elem):
        """1 - x for 0/1 flag columns."""
        return F.sub(F.const(1, mask_elem.device), mask_elem)

    @staticmethod
    def rescue_mds(state):
        """Rescue MDS layer on a stacked state [14, B]."""
        return R.mds_apply(state)

    @staticmethod
    def rescue_inv_mds(state):
        return R.mds_apply(state, inverse=True)

    @staticmethod
    def sbox3(state):
        """x -> x^3 elementwise."""
        return R.sbox(state)


BASE = BaseFieldOps()
