"""Carry field data across between the JAX package and the port.

The JAX package stores an element as four 16-bit limbs on a leading axis of
a uint32 array (certificate_stark_tpu/ops/field.py `pack_u64`/`unpack_u64`);
the port stores the same Montgomery u64 bit pattern in one int64. These two
functions play the role that weight conversion plays for a model: the tests
feed numpy-seeded inputs to both packages through them.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_limbs(limbs) -> torch.Tensor:
    """[4, *S] uint32 16-bit limbs -> int64 CPU tensor [*S]."""
    a = np.asarray(limbs).astype(np.uint64)
    assert a.shape[0] == 4
    v = a[0] | (a[1] << np.uint64(16)) | (a[2] << np.uint64(32)) \
        | (a[3] << np.uint64(48))
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int64))


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """int64 tensor [*S] -> [4, *S] uint32 16-bit limbs."""
    v = np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint64)
    return np.stack([((v >> np.uint64(16 * i)) & np.uint64(0xFFFF))
                     .astype(np.uint32) for i in range(4)])
