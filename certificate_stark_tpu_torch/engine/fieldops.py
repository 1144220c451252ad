"""Field-ops facades that AIR constraint code is written against.

Counterpart of certificate_stark_tpu/engine/fieldops.py. The same constraint
code runs through two facades:

  BASE           int64 Montgomery tensors [*S] on the device: every domain
                 point at once, in the base field (the prover's hot path);
  HostExtOps(d)  numpy object arrays of d-tuples of standard-form Python
                 ints: the single out-of-domain point z in the extension of
                 degree d (the verifier; d = 1 serves base-field proofs).

A frame is [w, B], and `col`/`cols` select along the leading column axis.
Every JAX axis index is one lower here (no limb axis). Constants are made
beside a reference array `like`: a 0-dim constant broadcasts against any
shape, where the JAX facades' `const` takes the rank it must broadcast
against. Constraint code builds and joins arrays only through the facade
(`const`, `embed`, `stack`, `cat`, `cat1`, `expand`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import extfield as XF, field as F, rescue as R
from ..params import data as D


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
    def cat(parts, dim):
        return torch.cat(parts, dim=dim)

    @staticmethod
    def expand(a, like):
        """a broadcast to like's shape."""
        return a.expand_as(like)

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


def _array(x):
    """A frompyfunc result as an object array (0-dim for one element)."""
    if isinstance(x, np.ndarray):
        return x
    out = np.empty((), dtype=object)
    out[()] = x
    return out


class HostExtOps:
    """Host facade over the extension of degree d: numpy object arrays of
    d-tuples of standard-form ints, laid out as the device frames ([w, B],
    B = 1 at the OOD point). Speed is beside the point; the constraint code
    is the prover's own."""

    def __init__(self, degree: int):
        d = self.degree = degree
        P = F.P
        self._zero = (0,) * d
        self._add = np.frompyfunc(
            lambda a, b: tuple((x + y) % P for x, y in zip(a, b)), 2, 1)
        self._sub = np.frompyfunc(
            lambda a, b: tuple((x - y) % P for x, y in zip(a, b)), 2, 1)
        self._mul = np.frompyfunc(
            lambda a, b: tuple(XF.host_ext_mul(a, b, d)), 2, 1)
        self._neg = np.frompyfunc(lambda a: tuple((-x) % P for x in a), 1, 1)
        self._inv = np.frompyfunc(
            lambda a: tuple(XF.host_ext_inv(list(a), d)), 1, 1)

    def lift(self, x: int) -> tuple:
        return (int(x) % F.P,) + (0,) * (self.degree - 1)

    # -- elementwise --------------------------------------------------------
    def add(self, a, b):
        return _array(self._add(a, b))

    def sub(self, a, b):
        return _array(self._sub(a, b))

    def mul(self, a, b):
        return _array(self._mul(a, b))

    def square(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    def neg(self, a):
        return _array(self._neg(a))

    def inv(self, a):
        return _array(self._inv(a))

    def zeros_like(self, a):
        out = np.empty(np.shape(a), dtype=object)
        # fill() stores the tuple as one object a cell
        out.fill(self._zero)
        return out

    # -- structure ----------------------------------------------------------
    def const(self, x: int, like=None):
        out = np.empty((), dtype=object)
        out[()] = self.lift(x)
        return out

    def embed(self, ints, like=None):
        """Standard-form ints -> constant column [k, 1]."""
        return self.from_coeffs([[v] for v in ints])

    def from_coeffs(self, coeff_lists):
        """Extension elements as coefficient lists -> column [k, 1]."""
        out = np.empty((len(coeff_lists), 1), dtype=object)
        for i, c in enumerate(coeff_lists):
            c = [int(v) % F.P for v in c]
            out[i, 0] = tuple(c + [0] * (self.degree - len(c)))
        return out

    @staticmethod
    def stack(elems, dim=0):
        return np.stack(elems, axis=dim)

    @staticmethod
    def cat(parts, dim):
        return np.concatenate(parts, axis=dim)

    @staticmethod
    def cat1(parts):
        return np.concatenate(parts, axis=0)

    @staticmethod
    def expand(a, like):
        return np.broadcast_to(a, np.shape(like))

    @staticmethod
    def col(arr, i):
        return arr[i]

    @staticmethod
    def cols(arr, lo, hi):
        return arr[lo:hi]

    def one_mask(self, mask_elem):
        return self.sub(self.const(1), mask_elem)

    # -- compound ops -------------------------------------------------------
    def _mds(self, state, table):
        """out[i] = sum_j M[i][j] * state[j] over axis -2 of [..., 14, B];
        M's entries are base-field ints."""
        P, d = F.P, self.degree
        s = np.moveaxis(np.asarray(state), -2, 0)           # [14, ...]
        out = np.empty(s.shape, dtype=object)
        for idx in np.ndindex(s.shape[1:]):
            col = [s[(j,) + idx] for j in range(14)]
            for i in range(14):
                row = table[14 * i:14 * i + 14]
                out[(i,) + idx] = tuple(
                    sum(m * v[c] for m, v in zip(row, col)) % P
                    for c in range(d))
        return np.moveaxis(out, 0, -2)

    def rescue_mds(self, state):
        return self._mds(state, D.RESCUE_MDS)

    def rescue_inv_mds(self, state):
        return self._mds(state, D.RESCUE_INV_MDS)

    def sbox3(self, state):
        return self.mul(state, self.mul(state, state))
