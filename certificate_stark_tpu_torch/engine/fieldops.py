"""Field-ops facade that AIR constraint code is written against.

Counterpart of the base-field `BaseFieldOps` of
certificate_stark_tpu/engine/fieldops.py. Elements are int64 tensors
[*S] (Montgomery); a frame is [w, B], and `col`/`cols` select along the
leading column axis. Every JAX axis index is one lower here (no limb axis).
Constants are made on the device of a reference tensor `like`: a 0-dim
tensor broadcasts against any shape, where the JAX facade's `const` takes
the rank it must broadcast against.
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
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def const(x: int, like):
        """0-dim Montgomery constant on like's device."""
        return F.const(x, like.device)

    @staticmethod
    def embed(ints, like):
        """Standard-form ints -> constant column [k, 1] on like's device
        (broadcasts over the batch axis)."""
        return F.from_ints(list(ints), like.device)[:, None]

    @staticmethod
    def stack(elems, dim=0):
        return torch.stack(elems, dim=dim)

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
