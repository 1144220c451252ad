"""AIR programs and the Examples that prove them.

`get_example` mirrors the reference's per-module example dispatch
(src/lib.rs `get_example` and the analogous constructors in
src/{schnorr,merkle,range}/mod.rs), as certificate_stark_tpu/models does:
name -> ready-to-prove Example with the module's default proof options
unless overridden.
"""
from __future__ import annotations


def get_example(name: str, size: int = 2, options=None, device=None,
                **kwargs):
    """Build an example by name: 'rescue-chain', 'range', 'merkle-init',
    'merkle-update', 'schnorr', or 'transaction' (the composed
    state-transition AIR). `size` = chain length / value / #txs / #sigs.
    Runs on the card unless `device` names another."""
    from ..engine.options import ProofOptions
    # reference get_example defaults: (42, 8, 0, Blake3, None, 4, 256)
    # (src/lib.rs:78-86); ProofOptions itself defaults to the algebraic
    # rescue hasher
    opts = options or ProofOptions(hash_fn="blake3")
    if name == "rescue-chain":
        from . import rescue_chain as M
        return M.RescueChainExample(size, opts, device=device)
    if name == "range":
        from . import range as M
        return M.RangeExample(size, opts, device=device)
    if name == "merkle-init":
        from . import merkle_init as M
        # single-tx leaf-hash program: no size parameter (reference
        # src/merkle/init/mod.rs get_example)
        return M.MerkleInitExample(opts, device=device, **kwargs)
    if name == "merkle-update":
        from . import merkle_update as M
        return M.MerkleUpdateExample(size, opts, device=device, **kwargs)
    if name == "schnorr":
        from . import schnorr as M
        return M.SchnorrExample(size, opts, device=device)
    if name == "transaction":
        from . import transaction as M
        return M.TransactionExample(size, opts, device=device, **kwargs)
    raise ValueError(f"unknown example '{name}'")
