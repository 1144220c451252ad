"""Fiat-Shamir public coin (host side).

Counterpart of certificate_stark_tpu/engine/coin.py `RandomCoin`: the state
is a digest of the hasher, reseeded with each commitment. Rescue mode: a
draw hashes (state, counter) and reads out the first element. Byte mode
(BLAKE3): a draw merges the state with the counter repeated digest_len
times and reads 63-bit values from word pairs, rejecting those >= p; the
proof-of-work bound is on the first 32-bit word. The optional journal
records every step, for the golden-transcript comparisons.
"""
from __future__ import annotations

from ..ops.field import P


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
