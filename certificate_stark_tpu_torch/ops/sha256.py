"""SHA-256: the plain PyTorch hash of batches of word-aligned messages, and
the host hash through hashlib.

Counterpart of certificate_stark_tpu/ops/sha256.py. The batched layout is
the JAX package's: a batch of messages is a word tensor [n_words, *B] of
big-endian u32 values (the SHA spec's words, held here in int64 and masked
after every add), digests are [8, *B] big-endian words. A field element
serializes as its 8-byte LE standard form, so element i of a row gives the
byte-swapped words 2i (low half) and 2i+1 (high half) (`felems_to_words`).

These are the plain versions of csrc/sha256.cu (ops/kernels.py).
"""
from __future__ import annotations

import hashlib

import torch

K = (0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
     0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
     0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
     0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
     0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
     0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
     0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
     0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
     0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
     0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
     0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def compress(state: list, block: list) -> list:
    """One SHA-256 compression: state (8 values), block (16 values) -> the
    new state as a list of 8 values."""
    w = list(block)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + K[i] + w[i]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & M32, a, b, c,
                                  (d + t1) & M32, e, f, g)
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def n_blocks(n_words: int) -> int:
    """Blocks of a message of n_words words: the words, the 0x80 word and
    the two length words, rounded up to 16."""
    return (n_words + 1 + 2 + 15) // 16


def sha256_words(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of a batch of equal-length messages of whole words.

    words: [n, *B] int64 big-endian u32 words. Returns digests [8, *B]."""
    n = words.shape[0]
    bitlen = 32 * n
    nb = n_blocks(n)
    pad = [0x80000000] + [0] * (16 * nb - n - 3) + [bitlen >> 32,
                                                   bitlen & M32]
    tail = torch.tensor(pad, dtype=torch.int64, device=words.device)
    tail = tail.reshape((-1,) + (1,) * (words.dim() - 1)).expand(
        (len(pad),) + tuple(words.shape[1:]))
    full = torch.cat([words, tail])
    state = [torch.full(words.shape[1:], v, dtype=torch.int64,
                        device=words.device) for v in IV]
    for blk in range(nb):
        state = compress(state, list(full[16 * blk:16 * blk + 16]))
    return torch.stack(state)


def bswap32(x):
    """Byte-swap u32 values (LE <-> BE words)."""
    return ((x >> 24) | ((x >> 8) & 0xFF00) | ((x << 8) & 0xFF0000)
            | ((x << 24) & 0xFF000000))


def felems_to_words(std: torch.Tensor) -> torch.Tensor:
    """Standard-form elements [k, *B] -> BE words [2k, *B] of each
    element's 8-byte LE serialization."""
    words = torch.stack([bswap32(std & M32), bswap32(std >> 32)], dim=1)
    return words.reshape((-1,) + tuple(std.shape[1:]))


def digest_words(data: bytes) -> tuple:
    """Host digest (hashlib) as 8 BE u32 words (the hasher's encoding)."""
    d = hashlib.sha256(data).digest()
    return tuple(int.from_bytes(d[4 * i:4 * i + 4], "big") for i in range(8))
