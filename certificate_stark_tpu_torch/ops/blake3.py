"""BLAKE3-256: the plain PyTorch single-chunk hash of batches of messages,
and the full host hash (chunk tree included) in Python ints.

Counterpart of certificate_stark_tpu/ops/blake3.py. The batched layout is
the JAX package's: a batch of messages is a word tensor [n_words, *B] of u32
values (held here in int64 and masked), digests are [8, *B]. Field elements
serialize as 8-byte LE standard form, so element i of a row gives words 2i
(low half) and 2i+1 (high half).

`compress` is written once over values that support +, ^, >>, << and &:
torch int64 tensors (the plain versions of csrc/blake3.cu, ops/kernels.py)
and Python ints (the host hash of the Fiat-Shamir coin).
"""
from __future__ import annotations

import numpy as np
import torch

IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _round(v, m):
    """One BLAKE3 round: 4 column and 4 diagonal G mixes."""
    _g(v, 0, 4, 8, 12, m[0], m[1])
    _g(v, 1, 5, 9, 13, m[2], m[3])
    _g(v, 2, 6, 10, 14, m[4], m[5])
    _g(v, 3, 7, 11, 15, m[6], m[7])
    _g(v, 0, 5, 10, 15, m[8], m[9])
    _g(v, 1, 6, 11, 12, m[10], m[11])
    _g(v, 2, 7, 8, 13, m[12], m[13])
    _g(v, 3, 4, 9, 14, m[14], m[15])


def compress(cv, block, counter: int, block_len: int, flags: int) -> list:
    """One BLAKE3 compression: cv (8 values), block (16 values) -> the new
    chaining value as a list of 8 values."""
    v = list(cv) + list(IV[:4]) + [counter & M32, (counter >> 32) & M32,
                                   block_len, flags]
    m = list(block)
    for rnd in range(7):
        _round(v, m)
        if rnd < 6:
            m = [m[MSG_PERM[i]] for i in range(16)]
    return [v[i] ^ v[i + 8] for i in range(8)]


# ---------------------------------------------------------------------------
# plain PyTorch: single-chunk hashing of a batch
# ---------------------------------------------------------------------------
def blake3_words(words: torch.Tensor, byte_len: int = None) -> torch.Tensor:
    """Single-chunk BLAKE3-256 of a batch of equal-length messages.

    words: [n, *B] int64 u32 LE words (zero-padded to byte_len, which
    defaults to 4n and is at most 1024). Returns digests [8, *B]."""
    n = words.shape[0]
    byte_len = 4 * n if byte_len is None else byte_len
    assert byte_len <= 1024, "single-chunk (<= 1024 bytes) messages only"
    assert (byte_len + 3) // 4 == n
    n_blocks = max(1, (byte_len + 63) // 64)
    pad = n_blocks * 16 - n
    if pad:
        words = torch.cat([words, words.new_zeros((pad,) + words.shape[1:])])
    cv = [torch.full(words.shape[1:], w, dtype=torch.int64,
                     device=words.device) for w in IV]
    for i in range(n_blocks):
        flags = (CHUNK_START if i == 0 else 0) | \
                (CHUNK_END | ROOT if i == n_blocks - 1 else 0)
        blen = byte_len - 64 * i if i == n_blocks - 1 else 64
        cv = compress(cv, words[16 * i:16 * i + 16], 0, blen, flags)
    return torch.stack(cv)


def felems_to_words_le(std: torch.Tensor) -> torch.Tensor:
    """Standard-form elements [k, *B] -> LE u32 words [2k, *B]."""
    words = torch.stack([std & M32, std >> 32], dim=1)    # [k, 2, *B]
    return words.reshape((-1,) + tuple(std.shape[1:]))


# ---------------------------------------------------------------------------
# host: full-spec BLAKE3 over byte strings (chunk tree included)
# ---------------------------------------------------------------------------
def _words_of(block: bytes) -> list:
    buf = block + b"\x00" * (64 - len(block))
    return [int(w) for w in np.frombuffer(buf, dtype="<u4")]


def _chunk_cv(chunk: bytes, counter: int, is_root: bool) -> list:
    cv = list(IV)
    n_blocks = max(1, (len(chunk) + 63) // 64)
    for i in range(n_blocks):
        blk = chunk[64 * i:64 * i + 64]
        flags = (CHUNK_START if i == 0 else 0) | \
                (CHUNK_END if i == n_blocks - 1 else 0) | \
                (ROOT if is_root and i == n_blocks - 1 else 0)
        cv = compress(cv, _words_of(blk), counter, len(blk), flags)
    return cv


def blake3_bytes(data: bytes) -> bytes:
    """Full BLAKE3-256 (default key, 32-byte output) of a message."""
    chunks = [data[i:i + 1024] for i in range(0, len(data), 1024)] or [b""]
    if len(chunks) == 1:
        cv = _chunk_cv(chunks[0], 0, True)
    else:
        # chunk tree: the left subtree holds the largest power-of-two
        # number of chunks below the total
        def subtree(lo: int, hi: int, is_root: bool) -> list:
            if hi - lo == 1:
                return _chunk_cv(chunks[lo], lo, False)
            split = 1 << ((hi - lo - 1).bit_length() - 1)
            block = subtree(lo, lo + split, False) + \
                subtree(lo + split, hi, False)
            return compress(IV, block, 0, 64,
                            PARENT | (ROOT if is_root else 0))
        cv = subtree(0, len(chunks), True)
    return np.array(cv, dtype="<u4").tobytes()


def digest_words(data: bytes) -> tuple:
    """Host digest as 8 LE u32 words (the hasher's digest encoding)."""
    return tuple(int(w) for w in np.frombuffer(blake3_bytes(data),
                                               dtype="<u4"))
