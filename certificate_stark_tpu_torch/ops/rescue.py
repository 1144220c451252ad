"""Rescue-Prime (Rescue-XLIX) over f63 on int64 tensors.

Counterpart of certificate_stark_tpu/ops/rescue.py: STATE_WIDTH=14, RATE=7,
DIGEST=7, 7 rounds, alpha=3, hash cycle 8 (8th ARK row all zero), sponge
without padding. A batch of states is [14, B] (the JAX [4, 14, B] without
the limb axis). Every permutation goes through `kernels.rescue_permutation`:
the CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from . import field as F
from . import kernels as K
from ..params import data as D

STATE_WIDTH = 14
RATE_WIDTH = 7
DIGEST_SIZE = 7
NUM_ROUNDS = 7
CYCLE_LENGTH = 8
INV_ALPHA = D.INV_ALPHA
TRUNC_DIGEST = 4  # commitment digests are truncated to 4 elements


def _mont_table(values, shape) -> np.ndarray:
    return np.array([F.mont_int(v) for v in values],
                    dtype=np.int64).reshape(shape)


# Montgomery-form constant tables (int64 numpy)
MDS = _mont_table(D.RESCUE_MDS, (14, 14))
INV_MDS = _mont_table(D.RESCUE_INV_MDS, (14, 14))
ARK = _mont_table([v for row in D.RESCUE_ARK for v in row], (8, 28))

_TABLES: dict = {}


def tables(device):
    """(MDS, INV_MDS, ARK) as tensors on `device`, cached."""
    key = str(torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.from_numpy(t).to(device)
                             for t in (MDS, INV_MDS, ARK))
    return _TABLES[key]


def sbox(state):
    """x -> x^3 elementwise."""
    return F.mul(state, F.square(state))


def inv_sbox(state):
    """x -> x^(1/3) elementwise (exponent INV_ALPHA)."""
    return F.pow_const(state, INV_ALPHA)


def mds_apply(state, inverse: bool = False):
    """MDS matrix-vector product over the lane axis of [..., 14, B]:
    out[i] = sum_j M[i][j] * state[j]."""
    mds, inv_mds, _ = tables(state.device)
    m = inv_mds if inverse else mds
    return F.mul_sum(m[:, :, None], state[..., None, :, :], dim=-2)


def apply_round(state, round_idx: int):
    """One Rescue round on [14, B] (reference rescue.rs:246-263)."""
    ark = tables(state.device)[2][round_idx % CYCLE_LENGTH]
    state = F.add(mds_apply(sbox(state)), ark[:14, None])
    state = F.add(mds_apply(inv_sbox(state)), ark[14:, None])
    return state


def permutation(state):
    """The 7-round permutation of [14, *B] states."""
    shape = state.shape
    flat = state.reshape(STATE_WIDTH, -1).contiguous()
    mds, _, ark = tables(state.device)
    if K.use_plain(flat):
        out = K.rescue_permutation_plain(flat, mds, ark)
    else:
        out = K.rescue_permutation(flat, mds, ark)
    return out.reshape(shape)


def digest(elements):
    """Sponge digest of [k, B] element columns -> [7, B]: absorb rate-width
    chunks by addition, permute after each, a trailing partial chunk too."""
    k = elements.shape[0]
    state = torch.zeros((STATE_WIDTH,) + tuple(elements.shape[1:]),
                        dtype=torch.int64, device=elements.device)
    for i in range(0, k, RATE_WIDTH):
        chunk = elements[i:i + RATE_WIDTH]
        c = chunk.shape[0]
        state[:c] = F.add(state[:c], chunk)
        state = permutation(state)
    return state[:DIGEST_SIZE]


def merge4(d0, d1):
    """2-to-1 merge of truncated digests [4, B] -> [4, B]: d0 -> state[0:4],
    d1 -> state[7:11], the rest zero (certificate_stark_tpu/ops/rescue.py
    `merge4`)."""
    state = torch.zeros((STATE_WIDTH,) + tuple(d0.shape[1:]),
                        dtype=torch.int64, device=d0.device)
    state[0:TRUNC_DIGEST] = d0
    state[7:7 + TRUNC_DIGEST] = d1
    return permutation(state)[:TRUNC_DIGEST]
