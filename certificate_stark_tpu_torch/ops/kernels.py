"""The port's hand-written Hopper kernels, their plain PyTorch versions and
the build loader.

Two kernels replace the Pallas kernels of the JAX package
(certificate_stark_tpu/ops/pallas_kernels.py):

  f63_mul             <- pallas_mul (:176-191), csrc/f63_mul.cu
  rescue_permutation  <- pallas_rescue_permutation (:142-160),
                         csrc/rescue_perm.cu

and seventeen replace XLA code of the JAX package:

  blake3_leaves, blake3_merge  <- engine/hasher.py Blake3Hasher
                                  hash_columns / merge_pairs, csrc/blake3.cu
  sha256_leaves, sha256_merge  <- engine/hasher.py Sha256Hasher
                                  hash_columns / merge_pairs, csrc/sha256.cu
  sha3_leaves, sha3_merge      <- engine/hasher.py Sha3Hasher
                                  hash_columns / merge_pairs, csrc/sha3.cu
  blake3_tree, sha256_tree,    <- engine/kernels.py tree_levels over
  sha3_tree                       Blake3Hasher / Sha256Hasher / Sha3Hasher
                                  merge_pairs: every level of a tree in one
                                  launch, csrc/tree.cuh in blake3.cu,
                                  sha256.cu and sha3.cu
  transaction_trace            <- models/trace_device.py build_trace_device,
                                  csrc/tx_trace.cu (its plain version is
                                  models/trace_device.py build_trace_plain)
  transaction_eval             <- models/transaction.py evaluate_transition
                                  and its helpers, csrc/air_eval.cu (its
                                  plain version runs the port's
                                  TransactionAir.evaluate_transition)
  compose                      <- engine/prover.py _pointwise_comp,
                                  csrc/compose.cu
  ntt, lde                     <- ops/ntt.py ntt / intt (:97, :311) and lde
                                  with coset_scale (:326, :315), whose
                                  Pallas kernel pallas_local_ntt was
                                  deleted: csrc/ntt.cu, one launch a pass
                                  of ntt_plan
  ood, deep, fri_fold          <- engine/prover.py phase_ood (:748),
                                  _deep_pointwise (:802) and fold_kernel
                                  (:1088) over engine/fri.py fold2_ext
                                  (:105): csrc/deep.cu

The CUDA sources are compiled at first use with nvcc for sm_90a, one shared
library with a plain C interface per source (all compiles started together),
into build/torch_kernels/ at the repository root, and loaded with ctypes. A
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises. `launches` on each wrapper counts
its kernel launches.

Field elements are canonical Montgomery u64 bit patterns (R = 2^64) held in
torch.int64. The plain versions split them into 32-bit halves with masks:
int64 multiply wraps and `>>` is arithmetic.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess

import torch

from . import blake3 as B3, sha256 as S2, sha3 as S3

P = 4719772409484279809                      # 2^62 + 2^56 + 2^55 + 1
NPRIME = (-pow(P, -1, 1 << 64)) % (1 << 64)  # 0x417fffffffffffff
INV_ALPHA = 3146514939656186539              # 0b1010111 (01)x27 1
M32 = 0xFFFFFFFF
_P_HI = P >> 32

# x -> x^INV_ALPHA as an addition chain: 61 squarings and 12 multiplies,
# where square-and-multiply takes 61 and 32. Each step (dst, src, k, w) is
# dst = src^(2^k) * w, with no multiply where w is None; the last dst is the
# result. csrc/rescue_perm.cu `inv_sbox` writes the same chain out.
INV_ALPHA_CHAIN = (
    ("x2", "x", 1, None), ("x5", "x2", 1, "x"), ("x21", "x5", 2, "x"),
    ("x85", "x21", 2, "x"), ("y", "x85", 0, "x2"),           # y = x^87
) + (("y", "y", 8, "x85"),) * 6 + (("y", "y", 6, "x21"), ("y", "y", 1, "x"))


def walk_chain(x, square, mul):
    """x^INV_ALPHA by INV_ALPHA_CHAIN, with the given square and multiply."""
    v = {"x": x}
    for dst, src, k, w in INV_ALPHA_CHAIN:
        r = v[src]
        for _ in range(k):
            r = square(r)
        v[dst] = r if w is None else mul(r, v[w])
    return v[INV_ALPHA_CHAIN[-1][0]]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"f63_mul": "f63_mul.cu", "rescue_perm": "rescue_perm.cu",
           "blake3": "blake3.cu", "sha256": "sha256.cu", "sha3": "sha3.cu",
           "tx_trace": "tx_trace.cu", "air_eval": "air_eval.cu",
           "compose": "compose.cu", "ntt": "ntt.cu", "deep": "deep.cu"}
_HEADERS = ("f63.cuh", "tree.cuh")

_LIBS: dict = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f63 Montgomery multiply (broadcasting)."""
    a0, a1 = a & M32, a >> 32                 # a < 2^63: a1 < 2^31
    b0, b1 = b & M32, b >> 32
    p00 = a0 * b0                             # < 2^64, wraps
    p01 = a0 * b1                             # < 2^63
    p10 = a1 * b0
    mid = ((p00 >> 32) & M32) + (p01 & M32) + (p10 & M32)
    hi = a1 * b1 + (p01 >> 32) + (p10 >> 32) + (mid >> 32)
    lo = a * b                                # low 64 bits, wrapped
    m = lo * NPRIME                           # mod 2^64 (NPRIME < 2^63)
    m0, m1 = m & M32, (m >> 32) & M32
    q01 = m0 * _P_HI                          # m * p with p = _P_HI*2^32 + 1
    mphi = m1 * _P_HI + (q01 >> 32) + (((q01 & M32) + m1) >> 32)
    u = hi + mphi + (lo != 0).to(torch.int64)  # < 2p < 2^63
    return torch.where(u >= P, u - P, u)


def _add_plain(a, b):
    d = a - (P - b)                           # a + b - p without overflow
    return torch.where(d < 0, d + P, d)


def _mds_plain(s, mds):
    """s: [14, N]; mds: [14, 14] -> [14, N]."""
    prod = mul_plain(mds[:, :, None], s[None, :, :])   # [14, 14, N]
    acc = prod[:, 0]
    for j in range(1, prod.shape[1]):
        acc = _add_plain(acc, prod[:, j])
    return acc


def rescue_permutation_plain(state: torch.Tensor, mds: torch.Tensor,
                             ark: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Rescue permutation of [14, N] states: the kernel's
    inverse s-box chain; its MDS sums reduced products (canonical values
    make any order of the field operations give the same bits)."""
    s = state
    for r in range(7):
        s = mul_plain(s, mul_plain(s, s))
        s = _add_plain(_mds_plain(s, mds), ark[r, :14, None])
        s = walk_chain(s, lambda r: mul_plain(r, r), mul_plain)
        s = _add_plain(_mds_plain(s, mds), ark[r, 14:, None])
    return s


def _std_plain(cols: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form, REDC(v * 1)."""
    return mul_plain(cols, torch.ones((), dtype=torch.int64,
                                      device=cols.device))


def _pairs(level: torch.Tensor) -> torch.Tensor:
    """[8, 2m] digest words -> [16, m] messages left || right."""
    return torch.cat([level[:, 0::2], level[:, 1::2]])


def blake3_leaves_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch leaf hashes: [k, B] Montgomery -> [8, B] words of the
    single-chunk BLAKE3 of each row's 8k bytes (8-byte LE standard form)."""
    return B3.blake3_words(B3.felems_to_words_le(_std_plain(cols)))


def blake3_merge_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Merkle level: [8, 2m] words -> [8, m], pair j hashed
    as the single-chunk BLAKE3 of the 64 bytes left || right."""
    return B3.blake3_words(_pairs(level))


def sha256_leaves_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch leaf hashes: [k, B] Montgomery -> [8, B] BE words of
    the SHA-256 of each row's 8k bytes (8-byte LE standard form)."""
    return S2.sha256_words(S2.felems_to_words(_std_plain(cols)))


def sha256_merge_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Merkle level: [8, 2m] BE words -> [8, m], pair j
    hashed as the SHA-256 of the 64 bytes left || right."""
    return S2.sha256_words(_pairs(level))


def sha3_leaves_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch leaf hashes: [k, B] Montgomery -> [8, B] LE words of
    the SHA3-256 of each row's 8k bytes (8-byte LE standard form)."""
    return S3.sha3_words(B3.felems_to_words_le(_std_plain(cols)))


def sha3_merge_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Merkle level: [8, 2m] LE words -> [8, m], pair j
    hashed as the SHA3-256 of the 64 bytes left || right."""
    return S3.sha3_words(_pairs(level))


# ---------------------------------------------------------------------------
# Merkle trees in one buffer
# ---------------------------------------------------------------------------
# A tree over n = 2^L leaves [8, n] keeps every level above them in one
# [8, n - 1] buffer: level l (n / 2^l digests, l = 1 .. L) from column
# n - n / 2^(l-1), the root at column n - 2.
TREE_LOG2 = 11          # a tree kernel's block owns 2^11 digests at most
# where that still makes 256 blocks or more (about two an SM of the H100);
# a smaller tree's blocks own 2^10, so that more SMs share it
TREE_HALF_BELOW = 256 << TREE_LOG2

# A stage of the tree kernels (csrc/tree.cuh TreeStage, fields in this
# order): its input level holds m digests (stage 0: the leaves; a later
# stage: the buffer's columns from src_col), cut into subtrees of `size` =
# 2^levels digests, one block each, hashed to their roots. A stage after
# the first runs on the last block of each `size` finished blocks of the
# stage before, counted at gate counter ctr + unit // size.
TreeStage = collections.namedtuple("TreeStage",
                                   "m size levels src_col ctr")


def tree_schedule(n: int, s: int = None) -> list:
    """The stages of a tree kernel over n leaves (a power of two) whose
    blocks own subtrees of at most 2^s digests (by default 2^11, or 2^10
    below TREE_HALF_BELOW leaves): stage 0 over the leaves, each later one
    over the roots of the one before, until one root."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"tree_schedule: {n} leaves, expected a power of 2")
    if s is None:
        s = TREE_LOG2 - (n < TREE_HALF_BELOW)
    stages, m, ctr = [], n, 0
    while m > 1:
        size = min(1 << s, m)
        stages.append(TreeStage(m, size, size.bit_length() - 1,
                                0 if m == n else n - 2 * m, ctr))
        if m < n:
            ctr += m // size
        m //= size
    return stages


def tree_levels_of(buf: torch.Tensor) -> list:
    """The levels above the leaves, as views of a tree's [8, n - 1] buffer,
    level 1 first, the root ([8, 1]) last."""
    views, col, m = [], 0, (buf.shape[1] + 1) // 2
    while m >= 1:
        views.append(buf[:, col:col + m])
        col, m = col + m, m // 2
    return views


def _check_tree_leaves(name: str, leaves: torch.Tensor):
    n = leaves.shape[-1]
    if leaves.dim() != 2 or leaves.shape[0] != 8 or n < 1 or n & (n - 1):
        raise ValueError(f"{name}: shape {tuple(leaves.shape)}, expected "
                         "(8, n) with n a power of two")


def tree_plain(merge_plain, leaves: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch tree: leaves [8, n] (n a power of two) -> the
    [8, n - 1] buffer of every level above them, level by level with
    `merge_plain`."""
    _check_tree_leaves("tree_plain", leaves)
    buf = torch.empty((8, leaves.shape[1] - 1), dtype=torch.int64,
                      device=leaves.device)
    level = leaves
    for view in tree_levels_of(buf):
        view[:] = merge_plain(level)
        level = view
    return buf


# ---------------------------------------------------------------------------
# the NTT and the coset LDE
# ---------------------------------------------------------------------------
# A block of csrc/ntt.cu holds NTT_TILE points in shared memory (its
# NTT_TILE_LOG): R cosets x G groups x one pass's n_p points, whose stages
# run in at most NTT_MAX_ROUNDS register rounds of at most NTT_KMAX; the
# LDE's first round at most NTT_LDE_K0 (its units run R cosets each).
NTT_TILE = 1 << 13
NTT_MAX_ROUNDS = 4
NTT_KMAX = 4
NTT_LDE_K0 = 2


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: {n} is not a power of two")
    return n.bit_length() - 1


def _mont(x: int) -> int:
    return (x << 64) % P


def _root(n: int, inverse: bool = False) -> int:
    from .ntt import root_of_unity
    w = root_of_unity(n)
    return pow(w, P - 2, P) if inverse else w


def _sub_plain(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def _powers_plain(base: int, count: int, device) -> torch.Tensor:
    """[base^0 .. base^(count-1)] Montgomery, by doubling with mul_plain."""
    tbl = torch.tensor([_mont(1)], dtype=torch.int64, device=device)
    cur = base % P
    while tbl.numel() < count:
        m = min(tbl.numel(), count - tbl.numel())
        step = torch.tensor(_mont(cur), dtype=torch.int64, device=device)
        tbl = torch.cat([tbl, mul_plain(tbl[:m], step)])
        cur = cur * cur % P
    return tbl[:count]


@functools.lru_cache(maxsize=64)
def _plain_twiddles(n: int, inverse: bool, device: str):
    """w^0 .. w^(n/2 - 1) of the n-th root (its inverse for the inverse),
    and the bit-reversal permutation of n."""
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for k in range(bits):
        rev |= ((idx >> k) & 1) << (bits - 1 - k)
    return _powers_plain(_root(n, inverse), max(n // 2, 1), device), rev


def ntt_plain(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch NTT along the last axis of [..., n] (natural order in
    and out): a bit-reversal gather, then log2 n radix-2 stages; the
    inverse multiplies by 1/n at the end."""
    n = a.shape[-1]
    _log2(n, "ntt_plain")
    if n == 1:
        return a.clone()
    lead = tuple(a.shape[:-1])
    master, rev = _plain_twiddles(n, inverse, str(a.device))
    x = a.index_select(-1, rev)
    m = 2
    while m <= n:
        half = m // 2
        xr = x.reshape(lead + (n // m, m))
        even, odd = xr[..., :half], xr[..., half:]
        t = mul_plain(odd, master[::n // m])
        x = torch.cat([_add_plain(even, t), _sub_plain(even, t)], dim=-1)
        m *= 2
    x = x.reshape(lead + (n,))
    if inverse:
        x = mul_plain(x, torch.tensor(_mont(pow(n, P - 2, P)),
                                      dtype=torch.int64, device=a.device))
    return x


def lde_plain(coeffs: torch.Tensor, blowup: int,
              offset: int) -> torch.Tensor:
    """Plain PyTorch LDE: coefficients [..., n] zero-padded to blowup * n,
    coefficient t times offset^t, then ntt_plain -> the evaluations over
    offset * <w_{blowup n}>."""
    n = coeffs.shape[-1]
    padded = torch.nn.functional.pad(coeffs, (0, (blowup - 1) * n))
    scaled = mul_plain(padded, _powers_plain(offset, blowup * n,
                                             coeffs.device))
    return ntt_plain(scaled)


def _rounds(lp: int, first=None) -> list:
    """log2 sizes of csrc/ntt.cu's register rounds for a pass of 2^lp
    points: the fewest of at most NTT_KMAX stages, as even as possible, the
    larger first; with `first`, a first round of at most that many."""
    if lp == 0:
        return [0]
    if first is not None and first < lp:
        return [first] + _rounds(lp - first)
    count = -(-lp // NTT_KMAX)
    return [lp // count + (i < lp % count) for i in range(count)]


def _swizzle(log_RG: int, k0: int, rounds: int, coset_loop: bool) -> tuple:
    """(c, sh, mask) of csrc/ntt.cu `slot`: a tile slot s is stored at
    s ^ (((s >> c) & mask) << sh). The first round's lanes step along u
    (coset_loop: not) and then along hb, whose lowest bit sits at slot bit
    c = log2(RG) + k0; the XOR brings those bits below bit 4, where the
    lanes' u bits do not reach, so that 16 lanes' u64 slots take 16
    distinct bank pairs. The later rounds' lanes step along u and lo: 16
    consecutive slots, permuted within their aligned group of 16."""
    if rounds == 1:
        return (1, 0, 0)
    if coset_loop:
        return (log_RG + k0, 0, 15)
    if log_RG >= 4:
        return (1, 0, 0)
    return (log_RG + k0, log_RG, (1 << (4 - log_RG)) - 1)


def ntt_plan(n: int, blowup: int = 1, tile: int = NTT_TILE,
             lde: bool = False) -> list:
    """The passes of csrc/ntt.cu for a transform of n points (lde: an LDE
    of blowup cosets): one pass where n fits a tile, else the fewest
    passes of at most tile / 2 points each (sizes as even as possible, the
    larger first), so that every pass's block holds G >= 2 groups. Each
    pass: log (log2 n_p), log_R (cosets a block), log_G (groups a block),
    rounds (log2 of each register round's unit; the LDE's first pass
    starts with one of at most NTT_LDE_K0, whose units run the R cosets),
    swizzle (c, sh, mask of the tile), points and smem_bytes a block (the
    tile and the n_p staged twiddle slots), blocks a column."""
    L, lb = _log2(n, "ntt_plan n"), _log2(blowup, "ntt_plan blowup")
    tl = _log2(tile, "ntt_plan tile")
    if tl < 2:
        raise ValueError(f"ntt_plan: tile {tile} below 4 points")
    if L <= tl:
        logs = [L]
    else:
        count = -(-L // (tl - 1))
        logs = [L // count + (i < L % count) for i in range(count)]
    passes, lgT = [], 0
    for p, lp in enumerate(logs):
        log_R = min(lb, tl - lp)
        log_G = min(L - lp if p == 0 else lgT, tl - lp - log_R)
        pts = 1 << (log_R + log_G + lp)
        coset_loop = lde and p == 0
        rounds = _rounds(lp, NTT_LDE_K0 if coset_loop else None)
        passes.append(dict(
            log=lp, log_R=log_R, log_G=log_G, rounds=rounds,
            swizzle=_swizzle(log_R + log_G, rounds[0], len(rounds),
                             coset_loop),
            points=pts, smem_bytes=8 * (pts + (1 << lp)),
            blocks=(blowup * n) // pts))
        lgT += lp
    return passes


def _pass_desc(ps: dict):
    """A pass's layout as csrc/ntt.cu `fill` reads it: log_R, log_G, the
    number of rounds, their NTT_MAX_ROUNDS log2 sizes, the swizzle."""
    ks = ps["rounds"] + [0] * (NTT_MAX_ROUNDS - len(ps["rounds"]))
    return (_int * 10)(ps["log_R"], ps["log_G"], len(ps["rounds"]), *ks,
                       *ps["swizzle"])


def _pow_ints(base: int, count: int) -> list:
    out, cur = [], 1
    for _ in range(count):
        out.append(_mont(cur))
        cur = cur * base % P
    return out


def _split_table(base: int, log_count: int, device, hi_factor: int = 1):
    """base^e for e < 2^log_count as lo[e mod 2^h] * hi[e >> h] (h =
    ceil(log_count / 2)), hi times hi_factor: (lo, hi, h), Montgomery."""
    h = (log_count + 1) // 2
    lo, hi, cur = _pow_ints(base, 1 << h), [], hi_factor % P
    for _ in range(1 << (log_count - h)):
        hi.append(_mont(cur))
        cur = cur * pow(base, 1 << h, P) % P
    return (torch.tensor(lo, dtype=torch.int64, device=device),
            torch.tensor(hi, dtype=torch.int64, device=device), h)


def round_twiddles(w: int, lp: int, rounds) -> list:
    """csrc/ntt.cu's staged twiddles of a pass of 2^lp points with root w
    (of order 2^lp) and register rounds `rounds`: for each round (s stages
    before it, k in it), stage t, ml < 2^t, lo < 2^s, the stage's twiddle
    w^(((ml << s) | lo) << (lp - 1 - s - t)); 2^lp - 1 standard-form ints
    (one 1 where lp = 0)."""
    out, s = [], 0
    for k in rounds:
        for t in range(k):
            out += [pow(w, ((ml << s) | lo) << (lp - 1 - s - t), P)
                    for ml in range(1 << t) for lo in range(1 << s)]
        s += k
    return out or [1]


NttTables = collections.namedtuple("NttTables",
                                   "rounds tw_lo tw_hi tw_hi0 h_tw ninv")


@functools.lru_cache(maxsize=64)
def ntt_tables(n: int, inverse: bool, passes: tuple,
               device: str) -> NttTables:
    """csrc/ntt.cu's tables for a transform of n points with passes
    ((log2 n_p, rounds), ...), from ops/ntt.py root_of_unity (the inverse
    root for the inverse): each pass's round twiddles, w_n^e split in two
    (tw_lo, tw_hi), the first pass's high table (tw_hi0: times 1/n for the
    inverse, which then needs no scale at its last pass where it has two
    passes or more), and 1/n, Montgomery; cached."""
    w = _root(n, inverse)
    rounds = tuple(torch.tensor([_mont(v) for v in round_twiddles(
        pow(w, n >> lp, P), lp, ks)], dtype=torch.int64, device=device)
                   for lp, ks in passes)
    ninv = pow(n, P - 2, P)
    tw_lo, tw_hi, h = _split_table(w, n.bit_length() - 1, device)
    tw_hi0 = _split_table(w, n.bit_length() - 1, device, ninv)[1] \
        if inverse else tw_hi
    return NttTables(rounds, tw_lo, tw_hi, tw_hi0, h, _mont(ninv))


@functools.lru_cache(maxsize=8)
def direct_table(n: int) -> torch.Tensor:
    """w_n^e for e < n, Montgomery (the LDE's store twiddles), on the host
    (pinned where there is a card); cached. An LDE copies it to its device
    for its own launches: at 2^20 it is 8 MB that would otherwise stay on
    the card through a proof's peak."""
    tbl = _powers_plain(_root(n), n, "cpu")
    return tbl.pin_memory() if torch.cuda.is_available() else tbl


@functools.lru_cache(maxsize=256)
def lde_tables(n: int, blowup: int, offset: int, device: str):
    """The LDE's w_bn^e (e < blowup n) and offset^t (t < n), each split in
    two: ((bw_lo, bw_hi, h_bw), (o_lo, o_hi, h_o)); cached."""
    bn = blowup * n
    return (_split_table(_root(bn), bn.bit_length() - 1, device),
            _split_table(offset % P, n.bit_length() - 1, device))


@functools.lru_cache(maxsize=64)
def scale_tables(n: int, scale_by: int, device: str, ninv: bool = True):
    """The fused inverse's s^t (t < n) split in two, times n^-1 in the
    high table where `ninv` (one pass: no twiddle carries it): (s_lo,
    s_hi, h_s); cached."""
    return _split_table(scale_by % P, n.bit_length() - 1, device,
                        pow(n, P - 2, P) if ninv else 1)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every kernel source that has no up-to-date library yet, one
    nvcc process per source, all started together. Returns {name: path}.
    The compiler's -Xptxas -v report goes to <library>.log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path + f".{os.getpid()}.tmp"
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp,
                                     os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, path)
    errors = []
    # each process compiles into its own .tmp and renames it into place
    # (atomic), so processes that reach this at once never load a partial
    # library: the ranks of parallel/ load what chip_smoke.py built
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        with open(path + ".log", "wb") as fh:
            fh.write(out)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          + out.decode(errors="replace"))
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_IP = ctypes.POINTER(_int)
# leaves, out, schedule (host int64), stages, n, gate counters, stream
_TREE_ARGS = [_vp, _vp, ctypes.POINTER(_ll), _int, _ll, _vp, _vp]
# the C entry points of each library and their argument types
_ENTRY_POINTS = {
    "f63_mul": {"f63_mul_launch": [_vp, _vp, _vp, _ll, _vp]},
    "rescue_perm": {"rescue_perm_launch": [_vp, _vp, _ll, _vp, _vp, _vp]},
    "blake3": {"blake3_leaves_launch": [_vp, _vp, _int, _ll, _vp],
               "blake3_merge_launch": [_vp, _vp, _ll, _vp],
               "blake3_tree_launch": _TREE_ARGS},
    "sha256": {"sha256_leaves_launch": [_vp, _vp, _int, _ll, _vp],
               "sha256_merge_launch": [_vp, _vp, _ll, _vp],
               "sha256_tree_launch": _TREE_ARGS},
    "sha3": {"sha3_leaves_launch": [_vp, _vp, _int, _ll, _vp],
             "sha3_merge_launch": [_vp, _vp, _ll, _vp],
             "sha3_tree_launch": _TREE_ARGS},
    "tx_trace": {"transaction_trace_launch":
                 [_vp] * 14 + [_int, _ll, _vp, _vp]},
    # cur, nxt, periodic and their row strides, mds, inv_mds, gen12, b3,
    # S, out, the schedule and its length, stream; the schedule, its
    # length, then shared memory bytes, blocks an SM, threads, tile (out)
    "air_eval": {"transaction_eval_launch":
                 [_vp, _ll, _vp, _ll, _vp, _ll] + [_vp] * 4
                 + [_ll, _vp, _IP, _int, _vp],
                 "transaction_eval_occupancy": [_IP, _int] + [_IP] * 4},
    # evals, its row stride, C; cur, its row stride; meta, At, NA, G;
    # xpow, zt_inv, b_invz, b_ev, their row stride, j0; t_alpha, t_beta,
    # b_alpha, b_beta, NB; d, S, out, stream; C, At, NA, G, d, S, then
    # shared memory bytes, blocks an SM, blocks in the grid (out)
    "compose": {"compose_launch":
                [_vp, _ll, _int, _vp, _ll, _vp, _int, _int, _int]
                + [_vp] * 4 + [_ll, _ll] + [_vp] * 4
                + [_int, _int, _ll, _vp, _vp],
                "compose_occupancy": [_int] * 5 + [_ll] + [_IP] * 3},
    # src, dst, C, log2 n, (log2 b,) the passes' log2 sizes and their
    # count, the pass, its layout (_pass_desc), its round twiddles; ntt:
    # the split w_n table and its split, the split scale table, its split,
    # 1/n and the scale kind; lde: the w_n table, the split w_bn and
    # offset tables and their splits; stream
    "ntt": {"ntt_launch": [_vp, _vp, _ll, _int, _IP, _int, _int, _IP]
            + [_vp] * 3 + [_int] + [_vp] * 2 + [_int, _ll, _int, _vp],
            "lde_launch": [_vp, _vp, _ll, _int, _int, _IP, _int, _int, _IP]
            + [_vp] * 4 + [_int] + [_vp] * 2 + [_int, _vp]},
    # ood: coef, its row stride, w; h and its coordinate and column
    # strides, k; pts, s, m, d, scratch and its blocks' rows, out, stream.
    # deep: lde, its row stride; h and its two strides; xs, pts, ood_z,
    # ood_zg, ood_h, g_z, g_zg, g_h, w, k, d, S, out, its row stride,
    # stream. fri_fold: src, its value and coordinate strides, L, j0, lo,
    # hi, h, step_inv, scale, xi and xi^2 (packed host bytes), d, fold,
    # out, its row length and log2, stream
    "deep": {"ood_launch": [_vp, _ll, _int, _vp, _ll, _ll, _int, _vp, _ll,
                            _ll, _int, _vp, _ll, _vp, _vp],
             "deep_launch": [_vp, _ll, _vp, _ll, _ll] + [_vp] * 8
             + [_int] * 3 + [_ll, _vp, _ll, _vp],
             "fri_fold_launch": [_vp, _ll, _ll, _ll, _ll, _vp, _vp, _int,
                                 _ll, _ll, ctypes.c_char_p, ctypes.c_char_p,
                                 _int, _int, _vp, _ll, _int, _vp]},
}


def _lib(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build()[name])
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(t: torch.Tensor, what: str, device=None, shape=None):
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: dtype {t.dtype}, expected torch.int64")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def f63_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of two int64 tensors of one shape."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"f63_mul: unsupported device {a.device}")
    _check(a, "f63_mul a")
    _check(b, "f63_mul b", a.device, a.shape)
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _raise_on(_lib("f63_mul").f63_mul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), stream),
        "f63_mul")
    f63_mul.launches += 1
    return out


f63_mul.launches = 0


def rescue_permutation(state: torch.Tensor, mds: torch.Tensor,
                       ark: torch.Tensor) -> torch.Tensor:
    """Rescue permutation of [14, N] int64 states with Montgomery tables
    mds [14, 14] and ark [8, 28] on the same device."""
    if state.device.type == "cpu":
        return rescue_permutation_plain(state, mds, ark)
    if state.device.type != "cuda":
        raise ValueError(f"rescue_permutation: unsupported device "
                         f"{state.device}")
    if state.dim() != 2 or state.shape[0] != 14:
        raise ValueError(f"rescue_permutation: state shape "
                         f"{tuple(state.shape)}, expected (14, N)")
    _check(state, "rescue_permutation state")
    _check(mds, "rescue_permutation mds", state.device, (14, 14))
    _check(ark, "rescue_permutation ark", state.device, (8, 28))
    out = torch.empty_like(state)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    _raise_on(_lib("rescue_perm").rescue_perm_launch(
        state.data_ptr(), out.data_ptr(), state.shape[1], mds.data_ptr(),
        ark.data_ptr(), stream), "rescue_permutation")
    rescue_permutation.launches += 1
    return out


rescue_permutation.launches = 0


def _leaves(wrapper, lib: str, cols: torch.Tensor, max_k=None):
    """Launch the leaf kernel `wrapper.__name__` of library `lib` on a
    [k, B] Montgomery int64 CUDA tensor (1 <= k <= max_k) -> [8, B]."""
    name = wrapper.__name__
    if cols.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {cols.device}")
    if cols.dim() != 2 or cols.shape[0] < 1 or \
            (max_k is not None and cols.shape[0] > max_k):
        raise ValueError(f"{name}: shape {tuple(cols.shape)}, expected "
                         f"(k, B) with 1 <= k <= {max_k or 'any'}")
    _check(cols, f"{name} cols")
    out = torch.empty((8, cols.shape[1]), dtype=torch.int64,
                      device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    _raise_on(getattr(_lib(lib), name + "_launch")(
        cols.data_ptr(), out.data_ptr(), cols.shape[0], cols.shape[1],
        stream), name)
    wrapper.launches += 1
    return out


def _merge(wrapper, lib: str, level: torch.Tensor):
    """Launch the merge kernel `wrapper.__name__` of library `lib` on one
    Merkle level, [8, 2m] int64 digest words on the card -> [8, m]."""
    name = wrapper.__name__
    if level.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {level.device}")
    if level.dim() != 2 or level.shape[0] != 8 or level.shape[1] % 2:
        raise ValueError(f"{name}: shape {tuple(level.shape)}, "
                         "expected (8, 2m)")
    _check(level, f"{name} level")
    m = level.shape[1] // 2
    out = torch.empty((8, m), dtype=torch.int64, device=level.device)
    stream = torch.cuda.current_stream(level.device).cuda_stream
    _raise_on(getattr(_lib(lib), name + "_launch")(
        level.data_ptr(), out.data_ptr(), m, stream), name)
    wrapper.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _tree_args(n: int):
    """A tree kernel's schedule over n leaves as the C entry point takes it
    (TreeStage fields, int64), its stage count and its gate counters."""
    stages = tree_schedule(n)
    words = [v for st in stages for v in st]
    return ((_ll * len(words))(*words), len(stages),
            sum(st.m // st.size for st in stages[1:]))


_TREE_CTR: dict = {}


def _tree_counters(device, stream: int, count: int) -> torch.Tensor:
    """Zeroed gate counters of the tree kernels on one stream: a launch
    leaves them zero, and the launches of one stream run in order."""
    ctr = _TREE_CTR.get((device, stream))
    if ctr is None or ctr.numel() < count:
        ctr = _TREE_CTR[device, stream] = torch.zeros(
            max(count, 64), dtype=torch.int32, device=device)
    return ctr


def _tree(wrapper, lib: str, leaves: torch.Tensor):
    """Launch the tree kernel `wrapper.__name__` of library `lib` on
    [8, n] int64 leaf digests on the card (n a power of two) -> the
    [8, n - 1] buffer of every level above them; one launch for n > 1."""
    name = wrapper.__name__
    if leaves.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {leaves.device}")
    _check_tree_leaves(name, leaves)
    _check(leaves, f"{name} leaves")
    n = leaves.shape[1]
    out = torch.empty((8, n - 1), dtype=torch.int64, device=leaves.device)
    if n == 1:
        return out
    sched, nstages, nctr = _tree_args(n)
    stream = torch.cuda.current_stream(leaves.device).cuda_stream
    ctr = _tree_counters(leaves.device, stream, nctr)
    _raise_on(getattr(_lib(lib), name + "_launch")(
        leaves.data_ptr(), out.data_ptr(), sched, nstages, n,
        ctr.data_ptr(), stream), name)
    wrapper.launches += 1
    return out


def blake3_leaves(cols: torch.Tensor) -> torch.Tensor:
    """BLAKE3 leaf hashes of the rows of a [k, B] Montgomery int64 tensor
    (k <= 128: one chunk) -> [8, B] int64 digest words."""
    if cols.device.type == "cpu":
        return blake3_leaves_plain(cols)
    return _leaves(blake3_leaves, "blake3", cols, max_k=128)


def blake3_merge(level: torch.Tensor) -> torch.Tensor:
    """One BLAKE3 Merkle level: [8, 2m] int64 digest words -> [8, m]."""
    if level.device.type == "cpu":
        return blake3_merge_plain(level)
    return _merge(blake3_merge, "blake3", level)


def blake3_tree(leaves: torch.Tensor) -> torch.Tensor:
    """Every BLAKE3 Merkle level above [8, n] int64 leaf digests, in one
    [8, n - 1] buffer (tree_levels_of): blake3_merge level by level."""
    if leaves.device.type == "cpu":
        return tree_plain(blake3_merge_plain, leaves)
    return _tree(blake3_tree, "blake3", leaves)


def sha256_leaves(cols: torch.Tensor) -> torch.Tensor:
    """SHA-256 leaf hashes of the rows of a [k, B] Montgomery int64 tensor
    -> [8, B] int64 BE digest words."""
    if cols.device.type == "cpu":
        return sha256_leaves_plain(cols)
    return _leaves(sha256_leaves, "sha256", cols)


def sha256_merge(level: torch.Tensor) -> torch.Tensor:
    """One SHA-256 Merkle level: [8, 2m] int64 digest words -> [8, m]."""
    if level.device.type == "cpu":
        return sha256_merge_plain(level)
    return _merge(sha256_merge, "sha256", level)


def sha256_tree(leaves: torch.Tensor) -> torch.Tensor:
    """Every SHA-256 Merkle level above [8, n] int64 leaf digests, in one
    [8, n - 1] buffer (tree_levels_of): sha256_merge level by level."""
    if leaves.device.type == "cpu":
        return tree_plain(sha256_merge_plain, leaves)
    return _tree(sha256_tree, "sha256", leaves)


def sha3_leaves(cols: torch.Tensor) -> torch.Tensor:
    """SHA3-256 leaf hashes of the rows of a [k, B] Montgomery int64 tensor
    -> [8, B] int64 LE digest words."""
    if cols.device.type == "cpu":
        return sha3_leaves_plain(cols)
    return _leaves(sha3_leaves, "sha3", cols)


def sha3_merge(level: torch.Tensor) -> torch.Tensor:
    """One SHA3-256 Merkle level: [8, 2m] int64 digest words -> [8, m]."""
    if level.device.type == "cpu":
        return sha3_merge_plain(level)
    return _merge(sha3_merge, "sha3", level)


def sha3_tree(leaves: torch.Tensor) -> torch.Tensor:
    """Every SHA3-256 Merkle level above [8, n] int64 leaf digests, in one
    [8, n - 1] buffer (tree_levels_of): sha3_merge level by level."""
    if leaves.device.type == "cpu":
        return tree_plain(sha3_merge_plain, leaves)
    return _tree(sha3_tree, "sha3", leaves)


for _fn in (blake3_leaves, blake3_merge, blake3_tree, sha256_leaves,
            sha256_merge, sha256_tree, sha3_leaves, sha3_merge, sha3_tree):
    _fn.launches = 0

# transaction_trace inputs, in the order of the C entry point: name ->
# shape of one transaction's slice ("d" = the tree depth)
TRACE_INPUTS = (("init", (94,)), ("sibs", (2, "d", 7)), ("path_bits", (2, "d")),
                ("pkey", (12,)), ("rx", (6,)), ("sbits", (256,)),
                ("hbits", (256,)), ("msg", (4, 7)), ("dbits", (64,)),
                ("gbits", (64,)))


def transaction_trace(inputs: dict, consts: dict, depth: int) -> torch.Tensor:
    """The composed AIR's Montgomery trace [94, T*1024] from the packed
    witness (models/trace_device.py `pack_witness`): `inputs` holds the
    per-transaction tensors of TRACE_INPUTS, `consts` the Montgomery
    tables gen12 [12], b3 [6], mds [14, 14], ark [8, 28]."""
    init = inputs["init"]
    if init.device.type == "cpu":
        from ..models.trace_device import build_trace_plain
        return build_trace_plain(inputs, consts, depth)
    if init.device.type != "cuda":
        raise ValueError(f"transaction_trace: unsupported device "
                         f"{init.device}")
    T = init.shape[0]
    if not 1 <= depth <= 63:
        raise ValueError(f"transaction_trace: depth {depth} not in 1..63")
    for name, shape in TRACE_INPUTS:
        shape = (T,) + tuple(depth if s == "d" else s for s in shape)
        _check(inputs[name], f"transaction_trace {name}", init.device, shape)
    for name, shape in (("gen12", (12,)), ("b3", (6,)), ("mds", (14, 14)),
                        ("ark", (8, 28))):
        _check(consts[name], f"transaction_trace {name}", init.device, shape)
    out = torch.empty((94, T * 1024), dtype=torch.int64, device=init.device)
    stream = torch.cuda.current_stream(init.device).cuda_stream
    ptrs = [inputs[name].data_ptr() for name, _ in TRACE_INPUTS] + \
        [consts[name].data_ptr() for name in ("gen12", "b3", "mds", "ark")]
    _raise_on(_lib("tx_trace").transaction_trace_launch(
        *ptrs, depth, T, out.data_ptr(), stream), "transaction_trace")
    transaction_trace.launches += 1
    return out


transaction_trace.launches = 0


# ---------------------------------------------------------------------------
# constraint evaluation and composition
# ---------------------------------------------------------------------------
TX_WIDTH, TX_SLOTS, TX_PERIODIC = 94, 115, 48
TX_CONSTS = (("mds", (14, 14)), ("inv_mds", (14, 14)), ("gen12", (12,)),
             ("b3", (6,)))

# transaction_eval's schedule, which csrc/air_eval.cu takes as a table at
# every launch. The Rescue round differences, one for each distinct
# register base (its 14 registers), each added into its flagged slot
# ranges (first slot, periodic flag column): merkle-init's rounds at setup
# (flag 0, setup), the Merkle authentication's (flag 4, hash_mask) and the
# Schnorr message hash's (flag 12, schnorr_hash).
EVAL_ROUNDS = ((0, ((0, 0), (0, 4))), (15, ((14, 0), (15, 4))),
               (29, ((28, 0), (29, 4))), (44, ((42, 0), (44, 4))),
               (42, ((42, 12),)))
# The item kinds in the kernel's order (csrc/air_eval.cu K_*), and the
# items each of a block's 8 warps runs, in turn, over the tile's 32
# points: (kind, parameter), the parameter a row of EVAL_ROUNDS or a point
# (0: s.G in cols 0..18, 1: h.P in cols 19..37). "own" writes slots 58..114
# alone, straight to the output; the others add into slots 0..57. Warp w
# issues on the SM's scheduler w % 4: the point formulas (about twice a
# round difference's instructions each) run on warps 5-7, one to a
# scheduler, beside the rounds. Of the orders timed on the H100 this was
# the fastest; those that spread the point formulas over more warps, or
# give every scheduler an equal share, were slower (PERF.md §6;
# scripts/profile_air_eval.py times such orders).
EVAL_KINDS = ("round", "double", "mixed", "full", "merkle", "hash", "range",
              "own")
EVAL_WARPS = ((("round", 0), ("hash", 0)), (("round", 1), ("own", 0)),
              (("round", 2), ("range", 0)), (("round", 3),), (("round", 4),),
              (("mixed", 0), ("double", 0)), (("mixed", 1), ("double", 1)),
              (("full", 0), ("merkle", 0)))
EVAL_ITEMS = 3            # items a warp at most
EVAL_SHARED_SLOTS = 58    # slots 0..57


def eval_item_slots(kind: str, param: int = 0) -> frozenset:
    """The result slots an item of transaction_eval's schedule writes."""
    if kind == "round":
        return frozenset(s + i for s, _ in EVAL_ROUNDS[param][1]
                         for i in range(14))
    ranges = {"double": (19 * param, 19 * param + 19),
              "mixed": (19 * param, 19 * param + 19), "full": (0, 18),
              "merkle": (0, 58), "hash": (38, 56), "range": (56, 58),
              "own": (EVAL_SHARED_SLOTS, TX_SLOTS)}
    return frozenset(range(*ranges[kind]))


@functools.lru_cache(maxsize=None)
def _eval_schedule():
    """EVAL_ROUNDS and EVAL_WARPS as the kernel's int table: a round's
    register base, slot and flag of each range (-1, 0 for a missing
    second), then each warp's items, kind << 3 | parameter, -1 after."""
    vals = []
    for reg, ranges in EVAL_ROUNDS:
        vals += [reg] + [v for r in ranges for v in r] + \
            [-1, 0] * (2 - len(ranges))
    for items in EVAL_WARPS:
        vals += [EVAL_KINDS.index(kind) << 3 | param
                 for kind, param in items] + [-1] * (EVAL_ITEMS - len(items))
    return (ctypes.c_int * len(vals))(*vals)


def transaction_eval_occupancy() -> dict:
    """The launch shape of transaction_eval on the current card:
    dynamic shared memory a block, resident blocks and warps an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads a block and
    points a tile."""
    sched = _eval_schedule()
    vals = [ctypes.c_int(0) for _ in range(4)]
    _raise_on(_lib("air_eval").transaction_eval_occupancy(
        sched, len(sched), *[ctypes.byref(v) for v in vals]),
        "transaction_eval_occupancy")
    smem, blocks, threads, tile = (v.value for v in vals)
    return dict(smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32, threads=threads,
                tile=tile)


def _row_stride(t: torch.Tensor, what: str, device, rows: int, S: int) -> int:
    """The row stride of a [rows, S] int64 view on `device` whose points
    (its last axis) are contiguous, as the kernels read it."""
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: dtype {t.dtype}, expected torch.int64")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dim() != 2 or tuple(t.shape) != (rows, S):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"({rows}, {S})")
    if S > 1 and t.stride(1) != 1:
        raise ValueError(f"{what}: its points are not contiguous")
    return t.stride(0)


def _host_ints(t: torch.Tensor) -> list:
    """Montgomery int64 values -> standard-form ints, on the host."""
    return [int(v) for v in mul_plain(t.cpu(), torch.ones(
        (), dtype=torch.int64)).tolist()]


def transaction_eval_plain(cur, nxt, periodic, consts):
    """Plain PyTorch transaction_eval: models/transaction.py
    `TransactionAir.evaluate_transition` through the BASE facade with the
    curve constants gen12 and b3 of `consts`; its MDS layers are
    ops/rescue.py's, the tables `consts` must hold."""
    from ..engine.fieldops import BASE
    from ..models.transaction import TransactionAir
    from .rescue import INV_MDS, MDS
    for name, table in (("mds", MDS), ("inv_mds", INV_MDS)):
        if not torch.equal(consts[name].cpu(), torch.from_numpy(table)):
            raise ValueError(f"transaction_eval_plain: {name} is not the "
                             "Rescue table")
    return TransactionAir.evaluate_transition(
        BASE, cur, nxt, periodic, gen12=_host_ints(consts["gen12"]),
        b3=_host_ints(consts["b3"]))


def transaction_eval(cur: torch.Tensor, nxt: torch.Tensor,
                     periodic: torch.Tensor, consts: dict) -> torch.Tensor:
    """The composed state-transition AIR's 115 transition-constraint slots
    [115, S] at the S points of the frames cur and nxt [94, S] with the
    periodic columns [48, S]: views whose points are contiguous, read
    through their row strides (no copy). `consts`: TransactionAir
    .eval_consts (mds, inv_mds [14, 14], gen12 [12], b3 [6], Montgomery).
    The plain version for a CPU tensor or inside plain_versions()."""
    if use_plain(cur):
        return transaction_eval_plain(cur, nxt, periodic, consts)
    if cur.device.type != "cuda":
        raise ValueError(f"transaction_eval: unsupported device {cur.device}")
    S = cur.shape[-1]
    lds = [_row_stride(t, f"transaction_eval {what}", cur.device, rows, S)
           for t, what, rows in ((cur, "cur", TX_WIDTH), (nxt, "nxt", TX_WIDTH),
                                 (periodic, "periodic", TX_PERIODIC))]
    for name, shape in TX_CONSTS:
        _check(consts[name], f"transaction_eval {name}", cur.device, shape)
    out = torch.empty((TX_SLOTS, S), dtype=torch.int64, device=cur.device)
    if S == 0:
        return out
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    sched = _eval_schedule()
    _raise_on(_lib("air_eval").transaction_eval_launch(
        cur.data_ptr(), lds[0], nxt.data_ptr(), lds[1], periodic.data_ptr(),
        lds[2], *[consts[name].data_ptr() for name, _ in TX_CONSTS], S,
        out.data_ptr(), sched, len(sched), stream), "transaction_eval")
    transaction_eval.launches += 1
    return out


transaction_eval.launches = 0

# The composition's tables over a prover's domain (count points), flattened
# once per Prover (engine/prover.py `_compose_tables`), as compose and
# compose_plain take them:
#   xpow [A, count]     x^adj, one row per degree adjustment
#   zt_inv [count]      the transition zerofier's inverse
#   b_invz [G, count]   each boundary group's inverse divisor
#   b_ev [R, count]     the rows of the groups whose values vary (sequences)
# and the host lists of the index tables, also on the device in `meta`
# (int64, in this order): the constraints grouped by degree adjustment,
# t_idx [C], group g from t_start[g] to t_start[g + 1] [At + 1], its xpow
# row t_row [At]; the assertions grouped by divisor, b_col [NA] (trace
# column), b_coef [NA] (its coefficients' column in b_alpha / b_beta),
# b_row [NA] (its b_ev row, or -1 for a constant), b_val [NA] (that
# constant, Montgomery), group g from b_start[g] to b_start[g + 1]
# [G + 1], its xpow row b_adj [G].
ComposeTables = collections.namedtuple(
    "ComposeTables", "xpow zt_inv b_invz b_ev meta t_idx t_start t_row "
    "b_col b_coef b_row b_val b_start b_adj")
_META = ("t_idx", "t_start", "t_row", "b_col", "b_coef", "b_row", "b_val",
         "b_start", "b_adj")


def compose_tables(xpow, zt_inv, b_invz, b_ev, t_groups, b_groups):
    """ComposeTables from the domain tables and the groups: t_groups
    [(xpow row, [constraint])], b_groups [(xpow row, [(trace column,
    coefficient column, b_ev row or -1, Montgomery constant)])]."""
    lists = dict(t_idx=[c for _, cs in t_groups for c in cs], t_start=[0],
                 t_row=[row for row, _ in t_groups], b_col=[], b_coef=[],
                 b_row=[], b_val=[], b_start=[0],
                 b_adj=[row for row, _ in b_groups])
    for _, cs in t_groups:
        lists["t_start"].append(lists["t_start"][-1] + len(cs))
    for _, members in b_groups:
        for col, coef, row, val in members:
            for key, v in zip(("b_col", "b_coef", "b_row", "b_val"),
                              (col, coef, row, val)):
                lists[key].append(v)
        lists["b_start"].append(len(lists["b_col"]))
    meta = torch.tensor([v for key in _META for v in lists[key]],
                        dtype=torch.int64, device=xpow.device)
    return ComposeTables(xpow=xpow, zt_inv=zt_inv, b_invz=b_invz, b_ev=b_ev,
                         meta=meta, **lists)


def compose_plain(evals, cur, j0, tabs, t_alpha, t_beta, b_alpha, b_beta):
    """Plain PyTorch compose, on the same tables."""
    from . import field as F
    dev, S = evals.device, evals.shape[-1]
    seg = slice(j0, j0 + S)
    # sum_c evals_c * (alpha_c + beta_c * x^adj_c), then / zerofier; base
    # evaluations times extension coefficients, coordinatewise
    comp = F.mul_sum(evals[None], t_alpha[:, :, None], dim=1)   # [d, S]
    for g, row in enumerate(tabs.t_row):
        sel = torch.tensor(tabs.t_idx[tabs.t_start[g]:tabs.t_start[g + 1]],
                           device=dev)
        part = F.mul_sum(evals[sel][None], t_beta[:, sel, None], dim=1)
        comp = F.add(comp, F.mul(part, tabs.xpow[row, seg]))
    comp = F.mul(comp, tabs.zt_inv[seg])
    # boundary terms, one divisor group at a time
    for g, row in enumerate(tabs.b_adj):
        members = range(tabs.b_start[g], tabs.b_start[g + 1])
        b_evals = torch.stack([
            tabs.b_ev[tabs.b_row[a], seg] if tabs.b_row[a] >= 0 else
            torch.full((S,), tabs.b_val[a], dtype=torch.int64, device=dev)
            for a in members])
        ci = torch.tensor([tabs.b_coef[a] for a in members], device=dev)
        num = F.sub(cur[[tabs.b_col[a] for a in members]], b_evals)[None]
        term = F.add(F.mul_sum(num, b_alpha[:, ci, None], dim=1),
                     F.mul(F.mul_sum(num, b_beta[:, ci, None], dim=1),
                           tabs.xpow[row, seg]))
        comp = F.add(comp, F.mul(term, tabs.b_invz[g, seg]))
    return comp


def compose(evals: torch.Tensor, cur: torch.Tensor, j0: int,
            tabs: ComposeTables, t_alpha: torch.Tensor, t_beta: torch.Tensor,
            b_alpha: torch.Tensor, b_beta: torch.Tensor) -> torch.Tensor:
    """H(x) at the S points j0 .. j0 + S - 1 of the tables' domain -> [d, S]:
    sum_c evals_c * (alpha_c + beta_c * x^adj_c) times the transition
    zerofier's inverse, plus for each boundary group the sum over its
    assertions of (cur[col] - b_ev) * (alpha + beta * x^adj) times the
    group's inverse divisor. evals [C, S] and the trace segment cur [w, S]
    are views whose points are contiguous; t_alpha, t_beta [d, C] and
    b_alpha, b_beta [d, NB] the extension coefficients (d = 1, 2, 3).
    The plain version for a CPU tensor or inside plain_versions()."""
    if use_plain(evals):
        return compose_plain(evals, cur, j0, tabs, t_alpha, t_beta, b_alpha,
                             b_beta)
    dev = evals.device
    if dev.type != "cuda":
        raise ValueError(f"compose: unsupported device {dev}")
    S, C, d = evals.shape[-1], len(tabs.t_idx), t_alpha.shape[0]
    count = tabs.zt_inv.shape[0]
    if not 1 <= d <= 3:
        raise ValueError(f"compose: extension degree {d} not in 1..3")
    if j0 < 0 or j0 + S > count:
        raise ValueError(f"compose: points [{j0}, {j0 + S}) outside the "
                         f"tables' {count}")
    ev_ld = _row_stride(evals, "compose evals", dev, C, S)
    cur_ld = _row_stride(cur, "compose cur", dev, cur.shape[0], S)
    if tabs.b_col and max(tabs.b_col) >= cur.shape[0]:
        raise ValueError("compose: an assertion's column is outside cur")
    nb = b_alpha.shape[-1]
    for t, what, shape in ((t_alpha, "t_alpha", (d, C)),
                           (t_beta, "t_beta", (d, C)),
                           (b_alpha, "b_alpha", (d, nb)),
                           (b_beta, "b_beta", (d, nb)),
                           (tabs.xpow, "xpow", (len(tabs.xpow), count)),
                           (tabs.zt_inv, "zt_inv", (count,)),
                           (tabs.b_invz, "b_invz", (len(tabs.b_adj), count)),
                           (tabs.b_ev, "b_ev", (len(tabs.b_ev), count)),
                           (tabs.meta, "meta", (len(tabs.meta),))):
        _check(t, f"compose {what}", dev, shape)
    out = torch.empty((d, S), dtype=torch.int64, device=dev)
    if S == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib("compose").compose_launch(
        evals.data_ptr(), ev_ld, C, cur.data_ptr(), cur_ld,
        tabs.meta.data_ptr(), len(tabs.t_row), len(tabs.b_col),
        len(tabs.b_adj), tabs.xpow.data_ptr(), tabs.zt_inv.data_ptr(),
        tabs.b_invz.data_ptr(), tabs.b_ev.data_ptr(), count, j0,
        t_alpha.data_ptr(), t_beta.data_ptr(), b_alpha.data_ptr(),
        b_beta.data_ptr(), nb, d, S, out.data_ptr(), stream), "compose")
    compose.launches += 1
    return out


compose.launches = 0


def compose_occupancy(tabs: ComposeTables, d: int, S: int) -> dict:
    """The launch shape of compose on the current card for these tables,
    extension degree d and S points, with the 16-byte loads of aligned
    rows (the prover's): dynamic shared memory a block, resident blocks an
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and blocks in the
    persistent grid."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    _raise_on(_lib("compose").compose_occupancy(
        len(tabs.t_idx), len(tabs.t_row), len(tabs.b_col), len(tabs.b_adj),
        d, S, *[ctypes.byref(v) for v in vals]), "compose_occupancy")
    smem, blocks, grid = (v.value for v in vals)
    return dict(smem_bytes=smem, blocks_per_sm=blocks, grid=grid)


def _transform_args(name: str, a: torch.Tensor):
    """Checks a contiguous int64 [C, n] CUDA tensor; -> (log2 n, the
    stream)."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dim() != 2:
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected (C, n)")
    _check(a, f"{name} input")
    return (_log2(a.shape[1], f"{name} n"),
            torch.cuda.current_stream(a.device).cuda_stream)


def _passes(name: str, src: torch.Tensor, out: torch.Tensor, n: int,
            plan: list, rounds: tuple, tail, keep=None) -> list:
    """One closure a pass of `plan`, launching it on `src` (pass 0) or in
    place on `out` and counting the launch on the wrapper `name`:
    ntt_launch or lde_launch, with the pass's round twiddles `rounds[p]`
    and the entry point's arguments after them, tail(p, last pass); each
    closure holds `keep` (a table its launch reads)."""
    C, L = src.shape[0], _log2(n, name)
    logs = [ps["log"] for ps in plan]
    lg = (_int * len(logs))(*logs)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    wrapper, entry = (ntt, "ntt_launch") if name == "ntt" \
        else (lde, "lde_launch")
    fns = []
    for p, ps in enumerate(plan):
        args = ((src if p == 0 else out).data_ptr(), out.data_ptr(), C, L) \
            + ((_log2(out.shape[1] // n, "lde blowup"),) if name == "lde"
               else ()) \
            + (lg, len(logs), p, _pass_desc(ps), rounds[p].data_ptr()) \
            + tail(p, p == len(plan) - 1) + (stream,)

        def launch(args=args, keep=keep):
            _raise_on(getattr(_lib("ntt"), entry)(*args), name)
            wrapper.launches += 1
        fns.append(launch)
    return fns


def _ntt_key(plan: list) -> tuple:
    return tuple((ps["log"], tuple(ps["rounds"])) for ps in plan)


def ntt_passes(a: torch.Tensor, out: torch.Tensor, inverse: bool = False,
               scale_by=None) -> list:
    """The launches of ntt(a, inverse, scale_by) into out, one closure a
    pass (the later ones in place on out): for timing a pass alone."""
    n = a.shape[1]
    plan = ntt_plan(n)
    dev = str(a.device)
    tabs = ntt_tables(n, bool(inverse), _ntt_key(plan), dev)
    one = len(plan) == 1    # else the first pass's twiddles carry 1/n
    if scale_by is None:
        s_lo = s_hi = tabs.tw_lo
        h_s, scale = 0, int(bool(inverse) and one)
    else:
        (s_lo, s_hi, h_s), scale = scale_tables(n, scale_by % P, dev, one), 2
    return _passes("ntt", a, out, n, plan, tabs.rounds, lambda p, last: (
        tabs.tw_lo.data_ptr(),
        (tabs.tw_hi0 if p == 0 else tabs.tw_hi).data_ptr(), tabs.h_tw,
        s_lo.data_ptr(), s_hi.data_ptr(), h_s, tabs.ninv,
        scale if last else 0))


def _scale_plain(x: torch.Tensor, scale_by: int) -> torch.Tensor:
    """Value t of the last axis times scale_by^t."""
    return mul_plain(x, _powers_plain(scale_by, x.shape[-1], x.device))


def ntt(a: torch.Tensor, inverse: bool = False,
        scale_by=None) -> torch.Tensor:
    """NTT (inverse: iNTT with 1/n) along the last axis of a contiguous
    int64 [C, n], natural order in and out: one launch a pass of
    ntt_plan(n), the first from a into the output, the later ones in place.
    With scale_by (a standard-form int, inverse only), value t of the
    inverse times scale_by^t, a multiply at the last pass's stores: the
    coefficients over the coset 1/scale_by <w_n> of the values a. The plain
    version (ntt_plain, and the scale by powers) for a CPU tensor or inside
    plain_versions(). `ntt.shapes` keeps every (C, n, inverse, scale_by mod
    p or None) launched in this process."""
    if scale_by is not None and not inverse:
        raise ValueError("ntt: scale_by is for the inverse only")
    if use_plain(a):
        out = ntt_plain(a, inverse)
        return out if scale_by is None else _scale_plain(out, scale_by)
    _transform_args("ntt", a)
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    for launch in ntt_passes(a, out, inverse, scale_by):
        launch()
    ntt.shapes.add((a.shape[0], a.shape[1], bool(inverse),
                    None if scale_by is None else scale_by % P))
    return out


ntt.launches = 0
ntt.shapes = set()


def lde_passes(coeffs: torch.Tensor, out: torch.Tensor, blowup: int,
               offset: int) -> list:
    """The launches of lde(coeffs, blowup, offset) into out, one closure a
    pass: for timing a pass alone."""
    n = coeffs.shape[1]
    plan = ntt_plan(n, blowup, lde=True)
    dev = str(coeffs.device)
    rounds = ntt_tables(n, False, _ntt_key(plan), dev).rounds
    (bw_lo, bw_hi, h_bw), (o_lo, o_hi, h_o) = lde_tables(
        n, blowup, offset % P, dev)
    tw_n = direct_table(n).to(dev, non_blocking=True)
    return _passes("lde", coeffs, out, n, plan, rounds, lambda p, last: (
        tw_n.data_ptr(), bw_lo.data_ptr(), bw_hi.data_ptr(), h_bw,
        o_lo.data_ptr(), o_hi.data_ptr(), h_o), keep=tw_n)


def lde(coeffs: torch.Tensor, blowup: int, offset: int) -> torch.Tensor:
    """Coefficients, a contiguous int64 [C, n] -> their evaluations over
    offset * <w_{blowup n}>, [C, blowup n] in natural order (blowup a power
    of two, offset a standard-form int): point r + blowup i is value i of
    the size-n transform of the coefficients times (offset w^r)^t. One
    launch a pass of ntt_plan(n, blowup, lde=True). The plain version for
    a CPU tensor or inside plain_versions(). `lde.shapes` keeps every (C,
    n, blowup, offset mod p) launched in this process."""
    if use_plain(coeffs):
        return lde_plain(coeffs, blowup, offset)
    _transform_args("lde", coeffs)
    _log2(blowup, "lde blowup")
    C, n = coeffs.shape
    out = torch.empty((C, blowup * n), dtype=torch.int64,
                      device=coeffs.device)
    if C == 0:
        return out
    for launch in lde_passes(coeffs, out, blowup, offset):
        launch()
    lde.shapes.add((C, n, blowup, offset % P))
    return out


lde.launches = 0
lde.shapes = set()


# ---------------------------------------------------------------------------
# the proof's tail: OOD values, the DEEP composition, the FRI fold
# ---------------------------------------------------------------------------
# csrc/deep.cu: a strip's coefficient indices (each s32 sum of byte
# products on the tensor cores has at most this many terms); the widest
# trace and composition that deep takes (its B fragments in shared memory)
OOD_STRIP = 1 << 9
DEEP_MAX_W, DEEP_MAX_K = 512, 32
# ood's partial sums: room for this many blocks (above the card's
# resident blocks; fewer where the coefficients are fewer)
OOD_BLOCKS = 1024


def _launch_device(t: torch.Tensor, name: str):
    """The CUDA device a kernel of this module launches on for t; raises on
    any other."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _ext_pow_plain(b: torch.Tensor, e: int, d: int) -> torch.Tensor:
    """b^e of extension values b [d, *S], by square-and-multiply."""
    from . import extfield as XF, field as F
    r = XF.base_to_ext(F.const(1, b.device).expand(b.shape[1:]), d)
    x = b
    while e:
        if e & 1:
            r = XF.ext_mul(r, x, d)
        e >>= 1
        if e:
            x = XF.ext_mul(x, x, d)
    return r


def ood_plain(coef, h_coeffs, pts, s: int = 0):
    """Plain PyTorch ood: the powers table of the points and the
    multiply-sums over it."""
    from . import extfield as XF, field as F
    d, m = pts.shape[0], coef.shape[-1]
    tbl = XF.ext_powers_dyn(pts, m, d)                     # [d, 3, m]
    if s:
        tbl = XF.ext_mul(tbl, _ext_pow_plain(pts, s, d)[..., None], d)
    ood = F.mul_sum(coef, tbl[:, :2, None, :], dim=-1)     # [d, 2, w]
    ood_h = XF.ext_mul_sum(h_coeffs, tbl[:, 2, None, :], d, dim=-1)
    return ood[:, 0], ood[:, 1], ood_h


def ood(coef: torch.Tensor, h_coeffs: torch.Tensor, pts: torch.Tensor,
        s: int = 0):
    """The out-of-domain values from coefficients whose index i carries the
    power s + i: the trace columns coef [w, m] (points contiguous) at z and
    z g, and the composition columns h_coeffs [d, k, m] (points contiguous)
    at z^k, with pts [d, 3] = (z, z g, z^k) -> (ood_z [d, w], ood_zg
    [d, w], ood_h [d, k]): sum_i c_i p^(s + i). The sharded prover's rank
    passes its block's first exponent s. Three launches a call
    (csrc/deep.cu: the powers' tables, ood_kernel over strips of OOD_STRIP
    indices on the tensor cores, the total of the blocks' partial sums),
    counted as one. The plain version for a CPU tensor or inside
    plain_versions(). `ood.shapes` keeps every (d, w, k, m, s) launched in
    this process."""
    if use_plain(coef):
        return ood_plain(coef, h_coeffs, pts, s)
    dev = _launch_device(coef, "ood")
    d, k, m = h_coeffs.shape
    w = coef.shape[0]
    if not 1 <= d <= 3:
        raise ValueError(f"ood: extension degree {d} not in 1..3")
    c_ld = _row_stride(coef, "ood coef", dev, w, m)
    if h_coeffs.device != dev or h_coeffs.dtype != torch.int64:
        raise ValueError("ood: h_coeffs must be int64 on the device of coef")
    if m > 1 and h_coeffs.stride(2) != 1:
        raise ValueError("ood: h_coeffs' points are not contiguous")
    _check(pts, "ood pts", dev, (d, 3))
    if s < 0:
        raise ValueError(f"ood: start exponent {s} < 0")
    out = torch.empty((d, 2 * w + k), dtype=torch.int64, device=dev)
    # the partial sums of at most `rows` blocks [rows, 2 d w + d^2 k], the
    # powers p^r [3, d, OOD_STRIP] and each strip's start power
    # [<= ceil(m / 32), 3, d] (the kernel picks strips of 32 ..
    # OOD_STRIP indices)
    rows = min(-(-m // 32), max(-(-m // OOD_STRIP), OOD_BLOCKS))
    scratch = torch.empty(rows * (2 * d * w + d * d * k)
                          + 3 * d * (OOD_STRIP + -(-m // 32)),
                          dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib("deep").ood_launch(
        coef.data_ptr(), c_ld, w, h_coeffs.data_ptr(), h_coeffs.stride(0),
        h_coeffs.stride(1), k, pts.data_ptr(), s, m, d, scratch.data_ptr(),
        rows, out.data_ptr(), stream), "ood")
    ood.launches += 1
    ood.shapes.add((d, w, k, m, s))
    return out[:, :w], out[:, w:2 * w], out[:, 2 * w:]


ood.launches = 0
ood.shapes = set()


def deep_plain(lde, h_lde, xs, pts, ood_z, ood_zg, ood_h, g_z, g_zg, g_h):
    """Plain PyTorch deep: the three denominators' inverses from one
    batch inversion of their product (F.batch_inv: 0 maps to 0, so a
    point where one is 0 is 0), the numerators by multiply-sums."""
    from . import extfield as XF, field as F
    d, S = pts.shape[0], xs.shape[-1]
    # sum_j g_j f_j(p) for the three points, [d, 3]
    c = torch.stack([XF.ext_mul_sum(g_z, ood_z, d, dim=1),
                     XF.ext_mul_sum(g_zg, ood_zg, d, dim=1),
                     XF.ext_mul_sum(g_h, ood_h, d, dim=1)], dim=1)
    # x - p for the three points, [d, 3, S], and their inverses from one
    # inversion of their product
    den = torch.cat([F.sub(xs[None], pts[0][:, None])[None],
                     F.neg(pts[1:])[:, :, None].expand(d - 1, 3, S)])
    xz, xzg, xzk = den[:, 0], den[:, 1], den[:, 2]
    others = XF.ext_mul(torch.stack([xzg, xz, xz], dim=1),
                        torch.stack([xzk, xzk, xzg], dim=1), d)
    inv_all = XF.ext_inv_vec(XF.ext_mul(others[:, 2], xzk, d), d)
    inv_den = XF.ext_mul(others, inv_all[:, None], d)
    # numerators: sum_j g_j f_j(x) - sum_j g_j f_j(p)
    cur = lde[None]
    num = torch.stack([
        F.mul_sum(cur, g_z[:, :, None], dim=1),
        F.mul_sum(cur, g_zg[:, :, None], dim=1),
        XF.ext_mul_sum(h_lde, g_h[:, :, None], d, dim=1)], dim=1)
    q = XF.ext_mul(F.sub(num, c[:, :, None]), inv_den, d)   # [d, 3, S]
    return F.add(F.add(q[:, 0], q[:, 1]), q[:, 2])


def deep(lde: torch.Tensor, h_lde: torch.Tensor, xs: torch.Tensor,
         pts: torch.Tensor, ood_z: torch.Tensor, ood_zg: torch.Tensor,
         ood_h: torch.Tensor, g_z: torch.Tensor, g_zg: torch.Tensor,
         g_h: torch.Tensor, out=None) -> torch.Tensor:
    """The DEEP composition on S domain points -> [d, S] (into `out`, a
    [d, S] view whose points are contiguous, where given): sum_j g_z,j
    (f_j(x) - f_j(z)) / (x - z) + sum_j g_zg,j (f_j(x) - f_j(z g)) /
    (x - z g) + sum_j g_h,j (H_j(x) - H_j(z^k)) / (x - z^k), with the trace
    segment lde [w, S] and the composition segment h_lde [d, k, S] (views
    whose points are contiguous, read through their strides), the points
    xs [S], pts [d, 3] = (z, z g, z^k), the OOD values ood_z, ood_zg
    [d, w] and ood_h [d, k], and the coefficients g_z, g_zg [d, w] and
    g_h [d, k]. A point where a denominator is 0 is 0. The kernel takes
    w <= DEEP_MAX_W and k <= DEEP_MAX_K and raises beyond. The plain
    version for a CPU tensor or inside plain_versions(). `deep.shapes`
    keeps every (d, w, k, S) launched in this process."""
    if use_plain(lde):
        q = deep_plain(lde, h_lde, xs, pts, ood_z, ood_zg, ood_h, g_z,
                       g_zg, g_h)
        return q if out is None else out.copy_(q)
    dev = _launch_device(lde, "deep")
    w, S = lde.shape
    d, k = g_h.shape
    if not 1 <= d <= 3:
        raise ValueError(f"deep: extension degree {d} not in 1..3")
    if not (1 <= w <= DEEP_MAX_W and 1 <= k <= DEEP_MAX_K):
        raise ValueError(f"deep: {w} trace and {k} composition columns, "
                         f"the kernel takes 1..{DEEP_MAX_W} and "
                         f"1..{DEEP_MAX_K}")
    lde_ld = _row_stride(lde, "deep lde", dev, w, S)
    if h_lde.device != dev or h_lde.dtype != torch.int64 or \
            tuple(h_lde.shape) != (d, k, S):
        raise ValueError(f"deep: h_lde {tuple(h_lde.shape)} {h_lde.dtype} "
                         f"on {h_lde.device}, expected ({d}, {k}, {S}) "
                         f"int64 on {dev}")
    if S > 1 and (h_lde.stride(2) != 1 or xs.stride(0) != 1):
        raise ValueError("deep: h_lde's or xs's points are not contiguous")
    if xs.device != dev or tuple(xs.shape) != (S,):
        raise ValueError(f"deep: xs {tuple(xs.shape)} on {xs.device}")
    # the small inputs may be views (ood's outputs are column slices)
    small = tuple(t.contiguous() for t in (pts, ood_z, ood_zg, ood_h, g_z,
                                           g_zg, g_h))
    for t, what, shape in zip(small, ("pts", "ood_z", "ood_zg", "ood_h",
                                      "g_z", "g_zg", "g_h"),
                              ((d, 3), (d, w), (d, w), (d, k), (d, w),
                               (d, w), (d, k))):
        _check(t, f"deep {what}", dev, shape)
    if out is None:
        out = torch.empty((d, S), dtype=torch.int64, device=dev)
    out_ld = _row_stride(out, "deep out", dev, d, S)
    if S == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib("deep").deep_launch(
        lde.data_ptr(), lde_ld, h_lde.data_ptr(), h_lde.stride(0),
        h_lde.stride(1), xs.data_ptr(), *[t.data_ptr() for t in small],
        w, k, d, S, out.data_ptr(), out_ld, stream), "deep")
    deep.launches += 1
    deep.shapes.add((d, w, k, S))
    return out


deep.launches = 0
deep.shapes = set()


class FoldLayer:
    """One FRI layer's fold constants, worked out once (a Prover keeps one
    a layer, as the JAX package's `_build_fri_kernels` keeps a fold kernel
    a layer): the layer of `size` points on the domain offset * <gen>,
    folded by `fold` (2 or 4), value t of an output point j at position
    j + t step (step = size / fold); 1/x of its points split in two, (lo,
    hi, h) with (offset gen^e)^-1 = lo[e mod 2^h] hi[e >> h], gen^-step and
    1/fold, Montgomery, on `device`."""

    def __init__(self, offset: int, gen: int, size: int, fold: int,
                 device):
        if fold not in (2, 4) or size % fold:
            raise ValueError(f"FoldLayer: fold {fold} of {size} points")
        self.offset, self.gen, self.size, self.fold = offset % P, gen % P, \
            size, fold
        self.step = size // fold
        w_inv = pow(self.gen, P - 2, P)
        self.lo, self.hi, self.h = _split_table(
            w_inv, _log2(size, "FoldLayer size"), device,
            pow(self.offset, P - 2, P))
        self.device = self.lo.device
        self.step_inv = _mont(pow(w_inv, self.step, P))
        self.scale = _mont(pow(fold, P - 2, P))


def _fold_out(fold: int, d: int, L: int, out_fold: int):
    """The fold's output geometry: (shape, row length m, log2 of the rows'
    points m_log); [d, L] with m = L, m_log = 63, or the next layer's leaf
    rows [out_fold d, L / out_fold] (engine/fri.py leaf_rows)."""
    if not out_fold:
        return (d, L), L, 63
    m = L // out_fold if out_fold in (2, 4) and L % out_fold == 0 else 0
    if m < 1 or m & (m - 1):
        raise ValueError(f"fri_fold: {L} points into leaf rows of folding "
                         f"{out_fold}")
    return (out_fold * d, m), m, m.bit_length() - 1


def _xi_ints(xi, d: int) -> list:
    """The folding scalar's d coordinates (standard-form ints, as the coin
    draws them), checked."""
    xi = [int(v) % P for v in xi]
    if len(xi) != d:
        raise ValueError(f"fri_fold: xi of {len(xi)} coordinates, "
                         f"expected {d}")
    return xi


def _fold_scalars(xi: list, d: int):
    """The kernel's xi and xi^2 from the coin's d standard-form ints:
    Montgomery, three words each, packed for the launch."""
    from .extfield import host_ext_mul

    def pack(a):
        return struct.pack("<3Q", *[(v << 64) % P for v in a],
                           *[0] * (3 - d))
    return pack(xi), pack(host_ext_mul(xi, xi, d))


def fri_fold_plain(groups, xi, layer: FoldLayer, j0: int = 0,
                   out_fold: int = 0):
    """Plain PyTorch fri_fold: radix-2 folds of the values t and t + h of
    the groups (engine/fri.py fold_halves), then of the results with xi^2,
    1/x from engine/fri.py inv_xs_table at the positions j0 + j + t step;
    with out_fold, engine/fri.py leaf_rows of the result."""
    from ..engine import fri as FRI
    from . import extfield as XF, field as F
    fold, d, L = groups.shape
    _fold_out(fold, d, L, out_fold)
    xi = F.from_ints(_xi_ints(xi, d), groups.device)
    g = groups.transpose(0, 1)                             # [d, fold, L]
    o, gw = layer.offset, layer.gen
    while g.shape[1] > 1:
        h = g.shape[1] // 2
        inv_x = torch.stack([
            FRI.inv_xs_table(o * pow(gw, j0 + t * layer.step, P) % P, gw, L,
                             groups.device) for t in range(h)])  # [h, L]
        g = FRI.fold_halves(g[:, :h], g[:, h:], inv_x, xi)
        xi = XF.ext_mul(xi[:, None], xi[:, None], d)[:, 0]
        o, gw = o * o % P, gw * gw % P
    return FRI.leaf_rows(g[:, 0], out_fold) if out_fold else g[:, 0]


def fri_fold(groups: torch.Tensor, xi, layer: FoldLayer, j0: int = 0,
             out_fold: int = 0) -> torch.Tensor:
    """One FRI layer's fold of the values groups [fold, d, L] (a view whose
    points are contiguous; `layer` the FoldLayer of its layer): value t of
    point j sits at the layer's position j0 + j + t layer.step. Radix-2
    folds of the values t and t + fold/2 with the extension scalar xi
    (its d standard-form ints, as the coin draws it), then (fold 4) of the
    two results with xi^2. Returns [d, L], or with out_fold (2 or 4) the
    next layer's leaf rows [out_fold d, L / out_fold] (engine/fri.py
    leaf_rows of those values), written by the kernel itself. The plain
    version for a CPU tensor or inside plain_versions(). `fri_fold.shapes`
    keeps every (d, fold, L, layer size, j0) launched in this process."""
    if use_plain(groups):
        return fri_fold_plain(groups, xi, layer, j0, out_fold)
    dev = _launch_device(groups, "fri_fold")
    if groups.dim() != 3 or groups.dtype != torch.int64:
        raise ValueError(f"fri_fold: groups {tuple(groups.shape)} "
                         f"{groups.dtype}, expected int64 (fold, d, L)")
    fold, d, L = groups.shape
    if fold != layer.fold or not 1 <= d <= 3:
        raise ValueError(f"fri_fold: fold {fold} (the layer's "
                         f"{layer.fold}), degree {d}")
    if L > 1 and groups.stride(2) != 1:
        raise ValueError("fri_fold: the points are not contiguous")
    if j0 < 0 or j0 + L > layer.step:
        raise ValueError(f"fri_fold: points [{j0}, {j0 + L}) outside the "
                         f"step {layer.step}")
    if layer.device != dev:
        raise ValueError(f"fri_fold: the layer's tables on {layer.device}, "
                         f"the values on {dev}")
    shape, m, m_log = _fold_out(fold, d, L, out_fold)
    xi, xi2 = _fold_scalars(_xi_ints(xi, d), d)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    if L == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib("deep").fri_fold_launch(
        groups.data_ptr(), groups.stride(0), groups.stride(1), L, j0,
        layer.lo.data_ptr(), layer.hi.data_ptr(), layer.h, layer.step_inv,
        layer.scale, xi, xi2, d, fold, out.data_ptr(), m, m_log, stream),
        "fri_fold")
    fri_fold.launches += 1
    fri_fold.shapes.add((d, fold, L, layer.size, j0))
    return out


fri_fold.launches = 0
fri_fold.shapes = set()


WRAPPERS = (f63_mul, rescue_permutation, blake3_leaves, blake3_merge,
            blake3_tree, sha256_leaves, sha256_merge, sha256_tree,
            sha3_leaves, sha3_merge, sha3_tree, transaction_trace,
            transaction_eval, compose, ntt, lde, ood, deep, fri_fold)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0


# Callers (ops/field.py mul, ops/rescue.py permutation) take the plain
# versions on a CUDA tensor only inside `plain_versions()`: chip_smoke.py uses
# it to prove with the plain versions on the card and compare the bytes.
_PLAIN = [False]


def use_plain(t: torch.Tensor) -> bool:
    return _PLAIN[0] or t.device.type == "cpu"


@contextlib.contextmanager
def plain_versions():
    prev, _PLAIN[0] = _PLAIN[0], True
    try:
        yield
    finally:
        _PLAIN[0] = prev
