"""Phase-level checkpoints of a proof, for resuming it after a restart.

Counterpart of certificate_stark_tpu/engine/checkpoint.py, with its
contract: `save(key, **arrays)`, `load(key)`, `save_levels` and
`unpack_levels`; one .npz file a phase, written to a temporary name and
renamed into place, and a JSON manifest that maps each phase key to the
hash of the proving context it was saved under. A phase is resumed only
where its file exists and its manifest entry matches this context, so
artifacts of another statement, other options or another hasher are never
read.

The artifacts here are the prover's int64 Montgomery tensors: `save` moves
them to the host, `load` back to the checkpointer's device. The JAX
package's artifacts are uint32 limb arrays under the same keys and file
names, so the context hashed here starts with FORMAT, a tag of this
package's own: each package's artifacts are invisible to the other.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..utils import device as DV

FORMAT = "certificate_stark_tpu_torch/int64-montgomery/1"


class Checkpointer:
    """Directory-backed phase checkpoint store for one proving context
    (any JSON-serializable description: AIR, shape, options, public
    inputs, hasher). `load` puts the tensors on `device`: the card unless
    the caller names the CPU."""

    def __init__(self, directory: str, context=None, device=None):
        self.dir = directory
        self.device = DV.resolve(device)
        os.makedirs(directory, exist_ok=True)
        ctx_bytes = json.dumps([FORMAT, context], sort_keys=True,
                               default=int).encode()
        self.ctx = hashlib.sha256(ctx_bytes).hexdigest()[:16]
        self._manifest_path = os.path.join(directory, "MANIFEST.json")
        self._manifest = {}
        if os.path.exists(self._manifest_path):
            try:
                with open(self._manifest_path) as f:
                    self._manifest = json.load(f)
            except (OSError, ValueError):
                self._manifest = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.npz")

    def save(self, key: str, **arrays):
        """Persist a phase's named tensors or ints (atomic rename)."""
        tmp = self._path(key) + ".tmp.npz"    # savez keeps a .npz name
        np.savez(tmp, **{k: (v.cpu().numpy() if torch.is_tensor(v)
                             else np.asarray(v, dtype=np.int64))
                         for k, v in arrays.items()})
        os.replace(tmp, self._path(key))
        self._manifest[key] = self.ctx
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path)

    def load(self, key: str):
        """The phase's {name: int64 tensor on the device}, or None where it
        is absent or was saved under another context."""
        if self._manifest.get(key) != self.ctx:
            return None
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]).to(self.device)
                    for k in z.files}

    def save_levels(self, key: str, main_arrays: dict, levels: list):
        """Save a phase that carries a Merkle tree's levels."""
        packed = {f"level{i}": lvl for i, lvl in enumerate(levels)}
        self.save(key, **main_arrays, **packed, n_levels=len(levels))

    @staticmethod
    def unpack_levels(data: dict) -> list:
        return [data[f"level{i}"] for i in range(int(data["n_levels"]))]
