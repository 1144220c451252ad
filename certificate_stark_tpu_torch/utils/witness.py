"""Random-transaction witness generation (a copy of
certificate_stark_tpu/utils/witness.py) — mirrors
TransactionMetadata::build_random (reference src/lib.rs:235-464): a 2^depth
account tree, random sender/receiver accounts, per-transaction deltas sampled
to avoid under/overflow, Merkle paths captured around the two leaf updates
(sender path before, receiver path after — lib.rs:370-421).

Public keys: when the Schnorr layer is enabled, pkey = skey*G on the active
Cheetah-f63 instance (utils/curve.py). Without signatures (merkle-only
models), keys are random field elements.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..params.data import P
from . import account_tree as AT


@dataclass
class TxMetadata:
    depth: int
    initial_roots: list = field(default_factory=list)
    final_root: tuple = ()
    s_old_values: list = field(default_factory=list)
    r_old_values: list = field(default_factory=list)
    s_indices: list = field(default_factory=list)
    r_indices: list = field(default_factory=list)
    s_paths: list = field(default_factory=list)
    r_paths: list = field(default_factory=list)
    deltas: list = field(default_factory=list)
    signatures: list = field(default_factory=list)
    s_secret_keys: list = field(default_factory=list)

    def tx_dicts(self):
        return [dict(initial_root=self.initial_roots[i],
                     s_old=self.s_old_values[i], r_old=self.r_old_values[i],
                     delta=self.deltas[i], s_idx=self.s_indices[i],
                     r_idx=self.r_indices[i], s_path=self.s_paths[i],
                     r_path=self.r_paths[i])
                for i in range(len(self.deltas))]


def build_random(num_transactions: int, depth: int, seed: int = 0,
                 with_signatures: bool = False) -> TxMetadata:
    if with_signatures and num_transactions > 8:
        return build_random_batched(num_transactions, depth, seed)
    rng = random.Random(seed)
    size = 1 << depth
    md = TxMetadata(depth=depth)
    tree = AT.AccountTree(depth)
    values = {}
    secret_keys = {}

    if with_signatures:
        from . import curve as CV

    def new_account(idx):
        if with_signatures:
            skey = rng.randrange(1, CV.SCALAR_Q)
            pk = CV.pkey_coords(skey)
        else:
            skey = rng.randrange(1, P)
            pk = [rng.randrange(P) for _ in range(12)]
        balance = rng.getrandbits(64)
        nonce = rng.getrandbits(64)
        val = list(pk) + [balance % P, nonce % P]
        secret_keys[idx] = skey
        values[idx] = val
        tree.update_leaf(idx, AT.leaf_hash(val))
        return val

    s_indices = []
    for _ in range(num_transactions):
        idx = rng.getrandbits(64) % size
        s_indices.append(idx)
        new_account(idx)

    r_indices = []
    for i in range(num_transactions):
        r = rng.getrandbits(64) % size
        while r == s_indices[i]:
            r = rng.getrandbits(64) % size
        r_indices.append(r)
        if r not in values:
            new_account(r)

    for i in range(num_transactions):
        s, r = s_indices[i], r_indices[i]
        s_bal = values[s][12]
        r_bal = values[r][12]
        bound = min(s_bal if s_bal > 0 else 1, (1 << 64) - 1 - r_bal)
        delta = rng.getrandbits(64) % max(bound, 1)
        md.initial_roots.append(tree.root())
        md.s_old_values.append(list(values[s]))
        md.r_old_values.append(list(values[r]))
        md.s_indices.append(s)
        md.r_indices.append(r)
        md.deltas.append(delta)
        md.s_secret_keys.append(secret_keys[s])
        md.s_paths.append(tree.prove(s))
        values[s][12] = (values[s][12] - delta) % P
        values[s][13] = (values[s][13] + 1) % P
        values[r][12] = (values[r][12] + delta) % P
        tree.update_leaf(s, AT.leaf_hash(values[s]))
        tree.update_leaf(r, AT.leaf_hash(values[r]))
        md.r_paths.append(tree.prove(r))

    md.final_root = tree.root()

    if with_signatures:
        from . import curve as CV
        for i in range(num_transactions):
            msg = build_tx_message(md.s_old_values[i][:12], md.r_old_values[i][:12],
                                   md.deltas[i], md.s_old_values[i][13])
            md.signatures.append(CV.sign(msg, md.s_secret_keys[i], rng))
    return md


def build_tx_message(s_addr, r_addr, amount: int, nonce: int) -> list:
    """(s_pk || r_pk || delta || nonce) padded, reference src/lib.rs:467-481."""
    msg = list(s_addr) + list(r_addr) + [amount % P, nonce % P, 0, 0]
    assert len(msg) == 28
    return msg


def build_random_batched(num_transactions: int, depth: int,
                         seed: int = 0) -> TxMetadata:
    """Large-batch witness generation: key derivation and signing run through
    the batched curve kernels (utils/curve_batch.py) instead of per-account
    scalar loops. Statistically equivalent to build_random (different rng draw
    order, so roots differ for the same seed — witnesses are random data)."""
    from . import curve as CV
    from . import curve_batch as CB

    rng = random.Random(seed)
    size = 1 << depth
    md = TxMetadata(depth=depth)
    tree = AT.AccountTree(depth)

    s_indices = [rng.getrandbits(64) % size for _ in range(num_transactions)]
    r_indices = []
    for i in range(num_transactions):
        r = rng.getrandbits(64) % size
        while r == s_indices[i]:
            r = rng.getrandbits(64) % size
        r_indices.append(r)

    account_ids = list(dict.fromkeys(s_indices + r_indices))
    skeys = {idx: rng.randrange(1, CV.SCALAR_Q) for idx in account_ids}
    pkeys = dict(zip(account_ids, CB.batch_pkeys([skeys[i] for i in account_ids])))
    values = {}
    for idx in account_ids:
        values[idx] = list(pkeys[idx]) + [rng.getrandbits(64) % P,
                                          rng.getrandbits(64) % P]
        tree.update_leaf(idx, AT.leaf_hash(values[idx]))

    for i in range(num_transactions):
        s, r = s_indices[i], r_indices[i]
        s_bal, r_bal = values[s][12], values[r][12]
        bound = min(s_bal if s_bal > 0 else 1, (1 << 64) - 1 - r_bal)
        delta = rng.getrandbits(64) % max(bound, 1)
        md.initial_roots.append(tree.root())
        md.s_old_values.append(list(values[s]))
        md.r_old_values.append(list(values[r]))
        md.s_indices.append(s)
        md.r_indices.append(r)
        md.deltas.append(delta)
        md.s_secret_keys.append(skeys[s])
        md.s_paths.append(tree.prove(s))
        values[s][12] = (values[s][12] - delta) % P
        values[s][13] = (values[s][13] + 1) % P
        values[r][12] = (values[r][12] + delta) % P
        tree.update_leaf(s, AT.leaf_hash(values[s]))
        tree.update_leaf(r, AT.leaf_hash(values[r]))
        md.r_paths.append(tree.prove(r))
    md.final_root = tree.root()

    messages = [build_tx_message(md.s_old_values[i][:12],
                                 md.r_old_values[i][:12], md.deltas[i],
                                 md.s_old_values[i][13])
                for i in range(num_transactions)]
    md.signatures = CB.batch_sign(messages, md.s_secret_keys, rng)
    return md
