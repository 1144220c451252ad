"""SHA3-256 (Keccak-f[1600]): the plain PyTorch hash of batches of
word-aligned messages, and the host hash through hashlib.

Counterpart of certificate_stark_tpu/ops/sha3.py. The batched layout is the
JAX package's and BLAKE3's: a batch of messages is a word tensor
[n_words, *B] of little-endian u32 values (word 2i is the low half of lane
i), digests are [8, *B] LE words. Messages absorb at the SHA3-256 rate of
136 bytes (34 words) with the 0x06 ... 0x80 pad; a message of 34j words
takes a whole block of padding.

Each 64-bit lane is a (lo, hi) pair of u32 values in int64, as in the JAX
package: torch's `>>` on int64 is arithmetic and its `<<` past bit 63 is
not defined, so the plain version never holds 64 bits in one int64. These
are the plain versions of csrc/sha3.cu (ops/kernels.py).
"""
from __future__ import annotations

import hashlib

import torch

# rho rotations and the pi lane order, the tiny-keccak tables
ROTC = (1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
        27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44)
PILN = (10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
        15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1)
RC = (0x0000000000000001, 0x0000000000008082, 0x800000000000808a,
      0x8000000080008000, 0x000000000000808b, 0x0000000080000001,
      0x8000000080008081, 0x8000000000008009, 0x000000000000008a,
      0x0000000000000088, 0x0000000080008009, 0x000000008000000a,
      0x000000008000808b, 0x800000000000008b, 0x8000000000008089,
      0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
      0x000000000000800a, 0x800000008000000a, 0x8000000080008081,
      0x8000000000008080, 0x0000000080000001, 0x8000000080008008)

RATE_WORDS = 34    # SHA3-256: rate 136 bytes
M32 = 0xFFFFFFFF


def rotl64(lo, hi, r: int):
    """A 64-bit lane (lo, hi) rotated left by r (0 <= r < 64)."""
    if r >= 32:
        lo, hi, r = hi, lo, r - 32
    if r == 0:
        return lo, hi
    return (((lo << r) | (hi >> (32 - r))) & M32,
            ((hi << r) | (lo >> (32 - r))) & M32)


def keccak_round(st: list, rc: int) -> list:
    """One Keccak round (theta, rho, pi, chi, iota) on 25 (lo, hi) lanes."""
    c = [(st[x][0] ^ st[x + 5][0] ^ st[x + 10][0] ^ st[x + 15][0]
          ^ st[x + 20][0],
          st[x][1] ^ st[x + 5][1] ^ st[x + 10][1] ^ st[x + 15][1]
          ^ st[x + 20][1]) for x in range(5)]
    st = list(st)
    for x in range(5):
        r = rotl64(*c[(x + 1) % 5], 1)
        d = (c[(x + 4) % 5][0] ^ r[0], c[(x + 4) % 5][1] ^ r[1])
        for y in range(0, 25, 5):
            st[y + x] = (st[y + x][0] ^ d[0], st[y + x][1] ^ d[1])
    t = st[1]
    for i in range(24):
        j = PILN[i]
        st[j], t = rotl64(*t, ROTC[i]), st[j]
    out = []
    for y in range(0, 25, 5):
        row = st[y:y + 5]
        for x in range(5):
            out.append(tuple(row[x][h] ^ ((row[(x + 1) % 5][h] ^ M32)
                                          & row[(x + 2) % 5][h])
                             for h in range(2)))
    out[0] = (out[0][0] ^ (rc & M32), out[0][1] ^ (rc >> 32))
    return out


def keccak_f(st: list) -> list:
    """Keccak-f[1600] on 25 (lo, hi) lanes."""
    for rc in RC:
        st = keccak_round(st, rc)
    return st


def n_blocks(n_words: int) -> int:
    """Rate blocks of a message of n_words words: one more than the whole
    blocks it fills, so that the pad always fits."""
    return n_words // RATE_WORDS + 1


def sha3_words(words: torch.Tensor) -> torch.Tensor:
    """SHA3-256 of a batch of equal-length messages of whole words.

    words: [n, *B] int64 LE u32 words. Returns digests [8, *B]."""
    n = words.shape[0]
    nb = n_blocks(n)
    total = nb * RATE_WORDS
    pad = [0] * (total - n)
    pad[0] ^= 0x06                      # the first free byte, word-aligned
    pad[-1] ^= 0x80000000               # the last byte of the last block
    tail = torch.tensor(pad, dtype=torch.int64, device=words.device)
    tail = tail.reshape((-1,) + (1,) * (words.dim() - 1)).expand(
        (len(pad),) + tuple(words.shape[1:]))
    full = torch.cat([words, tail])
    zero = torch.zeros(words.shape[1:], dtype=torch.int64,
                       device=words.device)
    st = [(zero, zero)] * 25
    for blk in range(nb):
        base = blk * RATE_WORDS
        st = [(st[i][0] ^ full[base + 2 * i], st[i][1] ^ full[base + 2 * i + 1])
              if i < RATE_WORDS // 2 else st[i] for i in range(25)]
        st = keccak_f(st)
    return torch.stack([st[i // 2][i % 2] for i in range(8)])


def digest_words(data: bytes) -> tuple:
    """Host digest (hashlib) as 8 LE u32 words (the hasher's encoding)."""
    d = hashlib.sha3_256(data).digest()
    return tuple(int.from_bytes(d[4 * i:4 * i + 4], "little")
                 for i in range(8))
