"""Fiat-Shamir public coin (host side, Rescue mode).

Counterpart of certificate_stark_tpu/engine/coin.py `RandomCoin`: the state
is a truncated Rescue digest, reseeded with each commitment; a draw hashes
(state, counter) and reads out the first element. The optional journal
records every step, for the golden-transcript comparisons.
"""
from __future__ import annotations

from ..ops.field import P


class RandomCoin:
    def __init__(self, hasher, seed_elements, journal=None):
        assert hasher.name == "rescue"
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

    def draw_felt(self) -> int:
        """Uniform element of F_p."""
        self.counter += 1
        v = int(self.h.host_digest(list(self.state) + [self.counter])[0])
        if self.journal is not None:
            self.journal.append(("felt", v))
        return v

    def draw_felts(self, n: int) -> list:
        return [self.draw_felt() for _ in range(n)]

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
        lead = int(self.h.host_digest(list(self.state) + [int(nonce)])[0])
        return lead < 1 << (63 - grinding_bits)

    def grind(self, grinding_bits: int, max_iter: int = 1 << 26) -> int:
        """Smallest PoW nonce, by the host loop (grinding of 10 bits or
        fewer; the device search is not ported yet)."""
        if grinding_bits == 0:
            return 0
        if grinding_bits > 10:
            raise NotImplementedError(
                "grinding above 10 bits needs the device nonce search")
        for nonce in range(max_iter):
            if self.check_pow(nonce, grinding_bits):
                return nonce
        raise RuntimeError("grinding failed")
