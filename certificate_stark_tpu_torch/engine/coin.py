"""Fiat-Shamir public coin (host side).

Counterpart of certificate_stark_tpu/engine/coin.py `RandomCoin`: the state
is a digest of the hasher, reseeded with each commitment. Rescue mode: a
draw hashes (state, counter) and reads out the first element. Byte mode
(BLAKE3, SHA-256, SHA3-256): a draw merges the state with the counter
repeated digest_len times and reads 63-bit values from word pairs,
rejecting those >= p; the proof-of-work bound is on the first 32-bit word. The optional journal
records every step, for the golden-transcript comparisons.

Grinding above 10 bits searches nonces in increasing order in batches on
the device (the JAX package's `_grind_device`): one merge launch of the byte
hasher or one Rescue digest tests a batch, and the first hit is the host loop's
answer whatever the batch size.
"""
from __future__ import annotations

import torch

from ..ops import field as F, rescue as R
from ..ops.field import P
from ..utils import device as DV

# nonces a device batch tests (the JAX package's batch), and on the CPU,
# where the plain versions run
GRIND_BATCH = {"cuda": 1 << 15, "cpu": 1 << 10}


class RandomCoin:
    def __init__(self, hasher, seed_elements, journal=None):
        self.h = hasher
        self.state = hasher.host_digest([int(x) % P for x in seed_elements])
        self.counter = 0
        self.journal = journal
        if journal is not None:
            journal.append(("seed", [int(x) for x in self.state]))

    def reseed(self, commitment: tuple):
        self.state = self.h.host_merge(self.state, commitment)
        self.counter = 0
        if self.journal is not None:
            self.journal.append(("reseed", [int(x) for x in self.state]))

    def _block(self, value: int) -> tuple:
        """The hash of the state with one appended value (the counter or a
        PoW nonce)."""
        if self.h.name == "rescue":
            return self.h.host_digest(list(self.state) + [value])
        return self.h.host_merge(self.state, (value,) * self.h.digest_len)

    def _draw_felt_raw(self) -> int:
        while True:
            self.counter += 1
            blk = self._block(self.counter)
            if self.h.name == "rescue":
                return int(blk[0])            # already uniform in F_p
            for i in range(0, 8, 2):
                v = ((int(blk[i]) << 32) | int(blk[i + 1])) & ((1 << 63) - 1)
                if v < P:
                    return v

    def draw_felt(self) -> int:
        """Uniform element of F_p."""
        v = self._draw_felt_raw()
        if self.journal is not None:
            self.journal.append(("felt", v))
        return v

    def draw_felts(self, n: int) -> list:
        return [self.draw_felt() for _ in range(n)]

    def draw_ext(self, degree: int) -> list:
        """One extension element as `degree` base coefficients."""
        return self.draw_felts(degree)

    def draw_indices(self, n: int, domain_size: int) -> list:
        """n distinct indices in [0, domain_size), repeats rejected."""
        assert domain_size & (domain_size - 1) == 0
        mask = domain_size - 1
        out, seen = [], set()
        while len(out) < n:
            v = self.draw_felt() & mask
            if v not in seen:
                seen.add(v)
                out.append(v)
        return out

    def check_pow(self, nonce: int, grinding_bits: int) -> bool:
        if grinding_bits == 0:
            return True
        lead = int(self._block(int(nonce))[0])
        width = 63 if self.h.name == "rescue" else 32
        return lead < 1 << (width - grinding_bits)

    def grind(self, grinding_bits: int, device=None,
              max_iter: int = 1 << 26, batch: int = None) -> int:
        """Smallest PoW nonce: by the host loop up to 10 bits, above that by
        the batched search on `device` (the card unless the caller names
        another; the CPU runs the kernels' plain versions)."""
        if grinding_bits == 0:
            return 0
        if grinding_bits <= 10:
            for nonce in range(max_iter):
                if self.check_pow(nonce, grinding_bits):
                    return nonce
            raise RuntimeError("grinding failed")
        dev = DV.resolve(device)
        batch = batch or GRIND_BATCH[dev.type]
        for base in range(0, max_iter, batch):
            hits = self._hits(base, batch, grinding_bits, dev).nonzero()
            if hits.numel():
                nonce = base + int(hits[0, 0])
                assert self.check_pow(nonce, grinding_bits)
                return nonce
        raise RuntimeError("grinding failed")

    def _hits(self, base: int, batch: int, g: int, dev):
        """Which of the nonces base .. base + batch - 1 pass the g-bit PoW
        -> bool [batch]."""
        nonces = torch.arange(base, base + batch, dtype=torch.int64,
                              device=dev)
        state = torch.tensor([int(v) for v in self.state],
                             dtype=torch.int64, device=dev)
        if self.h.name == "rescue":
            # digest(state || nonce): 5 elements, one permutation
            msgs = F.to_mont(torch.cat([state[:, None].expand(-1, batch),
                                        nonces[None]]))
            lead = F.from_mont(R.digest(msgs)[0])
            return lead < (1 << (63 - g))
        # byte hashers: the merge of the state words with the nonce word
        # repeated digest_len times (`host_merge`), a batch in one level
        assert base + batch <= 1 << 32, "byte-hasher nonces are 32-bit words"
        level = torch.empty((self.h.digest_len, 2 * batch), dtype=torch.int64,
                            device=dev)
        level[:, 0::2] = state[:, None]
        level[:, 1::2] = nonces[None]
        return self.h.merge_pairs(level)[0] < (1 << (32 - g))
