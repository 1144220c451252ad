#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from certificate_stark_tpu_torch/csrc and
holds each against its plain PyTorch version on the card (f63_mul, the
Rescue permutation at every batch size a chain-1024 proof launches, the
BLAKE3 leaf and merge kernels at every shape a 128- or 1024-transaction
proof launches, the transaction trace at 128 transactions, depth 15; the
BLAKE3, SHA-256 and SHA3-256 tree kernels, which build every level of a
Merkle tree in one launch, at every leaf count 2^0 .. 2^21 and BLAKE3 up
to 2^23, beside the per-level merge loop they replace; the transaction
AIR's constraint evaluation and the pointwise composition on the
128-transaction proof's 2^20-point segment, the evaluation with each form
of the curve constant b3 and the composition at extension degrees 1, 2
and 3, also on an all-(p - 1) input that brings its unreduced sums
closest to 2^128; the NTT and the coset LDE, csrc/ntt.cu, at single
columns of 2^0 .. 2^23 points, at every shape the paths launched, at
[94, 2^20] -> 2^23 and on an all-(p - 1) input; the proof's tail,
csrc/deep.cu: the OOD values, the DEEP composition and the FRI fold, at
every shape the paths launched, the sharded ranks' included). Every proof
path checks one evaluation launch (the transaction AIR's) and one
composition launch a domain segment, launches of the ntt and lde kernels,
one ood launch, one deep launch a segment and one fri_fold launch a FRI
layer; its phase spans carry each phase's peak device memory. Two
main paths run with their launch counts set to 0 just before and read just
after: the rescue chain of length 1024 (Rescue commitments) and the
composed state-transition AIR at 128 transactions, depth 15, with bench.py's
options (BLAKE3 commitments); each is timed by phase after a warm-up and
profiled with torch.profiler. A third main path is the example CLI's
default at the same size: the cubic extension with BLAKE3 commitments, on
the same witness, timed by phase, verified by the port's verifier (and two
tampered copies rejected). The extension arithmetic is held against its
plain CPU results, and the batched PoW search on the card against the host
loop. The committed goldens are reproduced (rescue chain 16, base and
cubic, from tests/vectors/transcripts.json; rescue chain 1024, chain 16
quadratic with Rescue grinding, and the transaction proofs from
tests/vectors/torch_goldens.json), the port's verifier accepts the
chain-1024 and 128-transaction base proofs, and chain 8192 and the base and
cubic 128-transaction proofs are proven once more with the plain versions,
which must give the same bytes. The standalone AIRs (range, merkle-init,
merkle-update, Schnorr) reproduce their goldens, and run at the
reference's benchmark sizes with bench.py's options (range 64-bit,
merkle-init, merkle-update at 128 transactions depth 15 and Schnorr at 128
signatures, the last two traced by the trace kernel): each timed by phase,
verified by the port's verifier (a wrong public input rejected), the two
128-unit ones also main paths with their own launch counts, profiled and
proven with the plain versions (equal bytes). The SHA-256 and SHA3-256
leaf and merge kernels are held against their plain versions and hashlib
at every shape the SHA proofs launch, their goldens reproduced, their
batched PoW search held against the host loop, and two more main paths
run the 128-transaction AIR with them: the CLI's cubic defaults with
--hash-fn sha3 (proven again with the plain versions, equal bytes) and
bench.py's options with SHA-256 (its plain-versions proof at 16
transactions). Phase checkpoints are saved and resumed on the card (a
fresh prover fed a zero trace) for the 16-transaction BLAKE3 golden and
chain 1024. Last, the JAX package's north star: the composed AIR at 1024
transactions, depth 15 (trace 94 x 2^20, LDE 2^23, in domain segments of
2^20 points), on a witness built in a worker process from the script's
start (minutes of host Python, overlapping the phases before): the trace
kernel at that size held against its plain version on four transactions'
row blocks, and two more main paths, bench.py's options and the CLI's
cubic defaults, timed by phase, verified (tampered copies rejected) and
equal to the pinned proofs of tests/vectors/transaction_1024tx_d15_blake3;
the 128-transaction proof in eight segments equals the unchunked one.
The sharded prover (certificate_stark_tpu_torch/parallel/) runs as four
ranks sharing the one card over gloo (named; `phase_parallel`): the
16- and 2-transaction goldens, chain 1024 and the 128-transaction proof
with bench.py's options, equal to their pinned bytes on every rank, with
each rank's phase spans, collectives, peak memory and launches (the
128-transaction run is the main path `sharded4_tx128`). Any mismatch
raises. Prints a `kernels` JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Exits non-zero
without a result when there is no CUDA device or no port beside it.

    python3 chip_smoke.py --tx1024

runs the 1024-transaction phase alone, with the BLAKE3 kernel checks and
the chunked 128-transaction proof (~4 minutes, most of it the witness).

    python3 chip_smoke.py --sharded

runs phase_parallel alone, and

    python3 chip_smoke.py --parallel

the sharded prover on four cards, one rank a card over NCCL (fewer cards
raise): the 128-transaction base, SHA-256 and cubic proofs and the
1024-transaction base and cubic proofs, each equal to its pinned bytes on
every rank and timed beside the single card's proof of the same trace.

    python3 chip_smoke.py --trees

runs the tree kernels' checks and measurements alone,

    python3 chip_smoke.py --eval

the evaluation and composition kernels' (on a random trace LDE over the
128-transaction AIR's tables),

    python3 chip_smoke.py --ntt

the ntt and lde kernels' (at the transaction paths' shapes, each pass
timed alone),

    python3 chip_smoke.py --deep

the proof's tail alone: the ood, deep and fri_fold kernels (csrc/deep.cu)
bit for bit against their plain versions at the transaction paths' shapes
and timed (fri_fold in both output modes), and phase_ood, phase_deep and
the FRI folds of the 128- and 1024-transaction paths (base and cubic; AIR
tables, random inputs, no witness) apart from the coin draws, through the
kernels and through the PyTorch route they replaced, the folds also as
a loop copying every layer's rows runs them, and one warm FRI
phase of the cubic 128-transaction prover under torch.profiler (~1.5
minutes of script with the build), and

    python3 chip_smoke.py --hashes [blake3|sha256|sha3 ...]

the leaf and merge kernels' (all three hashes where none is named), for
comparing checkouts.
"""
import concurrent.futures
import contextlib
import copy
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM rates: memory from the NVIDIA data sheet (3.35 TB/s). There is no
# 64-bit integer multiply; the 32-bit integer multiply-add rate is the CUDA
# programming guide's 64 per clock per SM (compute capability 9.0) x 132 SMs
# x 1.98 GHz boost clock.
MEM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 64 * 132 * 1.98e9
# the int8 tensor cores, dense (NVIDIA data sheet; a multiply-add is two
# operations)
INT8_OPS_PER_S = 1979e12
# 32-bit multiplies (the low or the high half of one 32x32 product) in the
# least work known for each function. A Montgomery multiply: 8 for the four
# partial products of the 64x64->128 product, 4 for the two word-level REDC
# steps (m*k, low and high half; p = k*2^32 + 1). A squaring has three
# partial products. An MDS row sums 14 unreduced products and reduces once.
MULS_PER_MMUL = 12
MULS_PER_MSQR = 10
MULS_PER_MDS_ROW = 14 * 8 + 4
# a product added into an unreduced four-word sum (f63_mac), and the one
# reduction of such a sum (f63_redc_wide)
MULS_PER_MAC = 8
MULS_PER_REDC = 4
# the inverse s-box chain of ops/kernels.py INV_ALPHA_CHAIN
INV_ALPHA_SQR, INV_ALPHA_MUL = 61, 12
# one Rescue permutation: 7 rounds x 14 lanes x (s-box x^3: a squaring and a
# multiply; two MDS rows; the inverse s-box chain)
MULS_PER_PERM = 7 * 14 * (MULS_PER_MSQR + MULS_PER_MMUL + 2 * MULS_PER_MDS_ROW
                          + INV_ALPHA_SQR * MULS_PER_MSQR
                          + INV_ALPHA_MUL * MULS_PER_MMUL)
# BLAKE3: 32-bit integer instructions of one compression (7 rounds x 8 G
# mixes x (2 three-input adds, 2 adds, 4 xors, 4 funnel-shift rotates),
# and the 8 output xors), and of one Montgomery -> standard REDC of a leaf
# element. Integer add, logic and shift issue at the multiply-add rate
# (64 a clock per SM), so bound_ms takes them with the multiplies.
BLAKE3_OPS = 7 * 8 * 12 + 8
REDC_OPS = 10
# SHA-256: 32-bit integer instructions of one compression, with the card's
# three-input add (IADD3) and logic (LOP3) and its funnel-shift rotate: 48
# schedule words of 10 (sigma0 and sigma1: two rotates, a shift and a LOP3
# each; two IADD3s), 64 rounds of 14 (Sigma1 and Sigma0: three rotates and
# a LOP3 each; ch and maj a LOP3 each; two IADD3s for t1, one for a, an add
# for e) and the 8 output adds; one byte permute (PRMT) a leaf word
SHA256_OPS = 48 * 10 + 64 * 14 + 8
# a merge: two compressions, the second of the constant pad block, whose
# message schedule is known at compile time
SHA256_MERGE_OPS = 2 * SHA256_OPS - 48 * 10
# Keccak-f[1600] on 32-bit halves: a round's theta (the 5 column parities,
# two LOP3s a half; the 5 rotates by 1 of a parity, two funnel shifts each;
# each lane's s ^ C[x-1] ^ rotl(C[x+1], 1), one LOP3 a half), rho (24
# rotates of two funnel shifts; no amount is 0 or 32), chi (50 LOP3s) and
# iota (a xor a nonzero half of the round constant)
KECCAK_ROUND_OPS = 20 + 10 + 50 + 48 + 50
# Fp6 arithmetic of the trace kernel: an fp6 multiply is 6 fp2 multiplies
# of 3 Montgomery multiplies; the multiply by the curve constant b3 takes
# 6, 9 or 18 Montgomery multiplies (base-subfield, fp2 or full fp6 b3).
MULS_PER_F6MUL = 18 * MULS_PER_MMUL
MULS_PER_ROUND = MULS_PER_PERM // 7
# csrc/tx_trace.cu f6inv: 14 fp2 multiplies, 3 for the norm, the base-field
# inverse x^(p - 2) (63 squarings, a multiply a set bit), 2 for 1 / t
P_INV_MMULS = 63 + bin(4719772409484279809 - 2).count("1")
F6_INV_MMULS = 14 * 3 + 3 + P_INV_MMULS + 2
BENCH_OPTS = dict(num_queries=42, blowup=8, grinding_bits=0, hash_fn="blake3",
                  extension_degree=1, fri_folding=4, fri_max_remainder=256)
TX_COUNT, TX_DEPTH = 128, 15
# The JAX package's north star (bench.py:94-114 with BENCH_TX=1024): 1024
# transactions at depth 15, trace 94 x 2^20, LDE 2^23, proven in domain
# segments of 2^20 points; its trace kernel held against the plain version
# on the row blocks of these transactions
TX1024 = 1024
TX1024_BLOCKS = (0, 341, 682, TX1024 - 1)
# its pinned proofs: the base one's bytes (the JAX package's verifier
# accepts them) and the cubic one's sha256
TX1024_VECTOR = "transaction_1024tx_d15_blake3.json"
# the 128-transaction proof with bench options, and with bench options and
# SHA-256 commitments (sha256 of the bytes, and the length of the latter)
TX128_SHA256 = ("ccd61384ace1e33ca22fffff156a0250"
                "d46859ccb4916bd3f1d9ba7096c0dea0")
TX128_SHA256_PATH = ("9951a3f42437cd53c0be3545640d68dc"
                     "526e7eae9b4db3898dd2b325d957bceb", 366852)
# f63_mul checks: the MDS layer of the constraint evaluation ([14, 14, B]
# for chain 1024 and 128 transactions: the row of the kernels line), and
# the largest launch of the 1024-transaction path (the cubic composition's
# [3, 115, 2^20] products of a 2^20-point segment)
F63_SIZES = (14 * 14 * (1 << 15), 14 * 14 * (1 << 20), 3 * 115 * (1 << 20))
F63_ROW = 14 * 14 * (1 << 20)
# columns a plain-version call takes at once in the kernel checks (its
# temporaries take many times its input)
PLAIN_SLICE = 1 << 20
# The ntt and lde kernels' shapes on the transaction paths, for `--ntt`
# (the default run checks the shapes the wrappers recorded instead): the
# trace's iNTT and LDE (94 columns, blowup 8) at 128 and 1024 transactions,
# the composition's inverse over the LDE domain ([d, bn]; with the coset
# scale by 1/offset fused, "1/o", and without it) and
# its LDE ([8 d, n]: k = 8 columns a coordinate), base and cubic. An ntt
# shape is (C, n, inverse, scale). NTT_ROW and LDE_ROW are the kernels
# line's rows (the 128-transaction trace LDE phase); the 1024-transaction
# ones and the fused [3, 2^23] are timed too.
NTT_MAIN = tuple((C, n, True, None) for n in (1 << 17, 1 << 20)
                 for C in (94, 1, 3)) + ((1, 1 << 23, True, None),
                                         (3, 1 << 23, True, None)) \
    + tuple((d, n, True, "1/o") for n in (1 << 20, 1 << 23) for d in (1, 3))
LDE_MAIN = tuple((C, n, 8) for n in (1 << 17, 1 << 20) for C in (94, 8, 24))
NTT_ROW, LDE_ROW = (94, 1 << 17, True, None), (94, 1 << 17, 8)
NTT_TIMED = (NTT_ROW, (94, 1 << 20, True, None), (3, 1 << 23, True, None),
             (3, 1 << 23, True, "1/o"))
LDE_TIMED = (LDE_ROW, (94, 1 << 20, 8), (24, 1 << 20, 8))
# elements a plain-version NTT or LDE call outputs at once in the checks
NTT_PLAIN_SLICE = 1 << 25
# the checks' single columns, 2^0 .. 2^NTT_CHECK_LOG points; their
# all-(p - 1) input ([4, 2^20]: the NTT, and the LDE of its first 2^17
# points); the 1024-transaction trace LDE, checked in every run
NTT_CHECK_LOG = 23
NTT_FULL = (4, 1 << 20)
LDE_BIG = (94, 1 << 20, 8)
# The proof's tail (csrc/deep.cu) on the transaction paths (94 trace
# columns, 8 composition columns, d = 1 and 3), for `--deep` (the default
# run checks the shapes the wrappers recorded, these among them): ood
# (d, w, k, m, s) at 128 and 1024 transactions and on the four sharded
# ranks' coefficient blocks of both proofs (2^15 and 2^18 coefficients
# from r m); deep (d, w, k, S) on a 2^20-point segment (the whole
# 128-transaction domain, one segment of the 1024-transaction one and of
# a 1024-transaction rank's 2^21 points) and on a 128-transaction rank's
# 2^18 points; fri_fold (d, fold, L, layer size, j0) on every layer of
# both proofs, fold 4 down to 256 values, and on the ranks' blocks of
# every sharded layer of both (2^20 .. 2^10 and 2^23 .. 2^9 values, L a
# sixteenth from r L), with the layers below (2^8 .. 2^4 values, rows of
# the next layer's leaves of 16 .. 1 points); FOLD_MORE the other degree
# and fold and a rank's one-point block. Each fri_fold
# shape is checked in both output modes, the values [d, L] and the next
# layer's leaf rows. The first of each *_TIMED is the row of the kernels
# line (the cubic 128-transaction proof's).
TAIL_W, TAIL_K, TAIL_RANKS = 94, 8, 4
OOD_MAIN = tuple((d, TAIL_W, TAIL_K, m, 0) for m in (1 << 17, 1 << 20)
                 for d in (1, 3)) + tuple(
    (d, TAIL_W, TAIL_K, m, r * m) for m in (1 << 15, 1 << 18)
    for r in range(TAIL_RANKS) for d in (1, 3))
DEEP_MAIN = tuple((d, TAIL_W, TAIL_K, S) for S in (1 << 20, 1 << 18)
                  for d in (1, 3))
FOLD_MAIN = tuple((d, 4, size // 4, size, 0) for size in
                  (1 << e for e in range(4, 24)) for d in (1, 3)) + tuple(
    (d, 4, size // 16, size, r * size // 16) for size in
    (1 << e for e in range(9, 24)) for r in range(TAIL_RANKS)
    for d in (1, 3))
FOLD_MORE = tuple((d, f, size // f, size, 0) for d in (1, 2, 3)
                  for f in (2, 4) for size in (1 << 8, 1 << 20)) + tuple(
    (3, 4, 1, 4 * TAIL_RANKS, r) for r in range(TAIL_RANKS))
OOD_TIMED = ((3, TAIL_W, TAIL_K, 1 << 17, 0), (1, TAIL_W, TAIL_K, 1 << 17, 0),
             (1, TAIL_W, TAIL_K, 1 << 20, 0), (3, TAIL_W, TAIL_K, 1 << 20, 0))
DEEP_TIMED = ((3, TAIL_W, TAIL_K, 1 << 20), (1, TAIL_W, TAIL_K, 1 << 20))
FOLD_TIMED = ((3, 4, 1 << 18, 1 << 20, 0), (1, 4, 1 << 18, 1 << 20, 0),
              (1, 4, 1 << 20, 1 << 22, 0), (3, 4, 1 << 20, 1 << 22, 0),
              (3, 4, 1 << 8, 1 << 10, 0))
# the plain version's checks take column groups of ood (its [d, 2, cols, m]
# product) and point slices of deep (its [d, w, S] products)
TAIL_PLAIN_COLS, TAIL_PLAIN_POINTS = 16, 1 << 18
# Hash kernel checks: leaf shapes [k, B]; the first is the row of the
# kernels line. BLAKE3: the base path's trace rows, composition rows and
# first FRI layer, then ragged ones. SHA: the trace rows [94, 2^20], the
# composition rows of the cubic and base proofs [24 | 8, 2^20], the first
# FRI layer's [12 | 4, 2^18], then ragged ones and SHA3's rate boundary of
# 17 elements; BLAKE3 also the 1024-transaction trace rows [94, 2^23].
# Merge level sizes (pairs): every level of a 128-transaction proof's
# trees, and ragged ones; BLAKE3 also of a 1024-transaction proof's (up to
# 2^22 pairs). Since the tree kernels, only the PoW search (2^15 pairs)
# launches the merges. The rows stay at 2^19 pairs.
LEAF_SHAPES = ((94, 1 << 20), (8, 1 << 20), (4, 1 << 18), (94, 1000),
               (7, 333), (1, 1), (128, 3), (94, 1 << 23))
SHA_LEAF_SHAPES = ((94, 1 << 20), (24, 1 << 20), (8, 1 << 20), (12, 1 << 18),
                   (4, 1 << 18), (94, 1000), (17, 333), (34, 129), (16, 7),
                   (1, 1))
MERGE_PAIRS = sorted({1 << e for e in range(20)} | {3, 1000})
B3_MERGE_PAIRS = sorted(set(MERGE_PAIRS) | {1 << e for e in range(20, 23)})
ROW_PAIRS = 1 << 19
# Tree kernel checks (phase_trees): leaf counts 2^0 .. 2^21, which hold a
# block's subtree S (ops/kernels.py tree_schedule: 2^10 below 2^19 leaves,
# 2^11 from there) at S/2, S and 2S, and where S changes; BLAKE3 also up to
# 2^23 (the 1024-transaction trace tree), S^2 = 2^22 and one level either
# side, where the schedule gains a stage. The rows are at TREE_ROW leaves.
TREE_SIZES = {"blake3": [1 << e for e in range(24)],
              "sha256": [1 << e for e in range(22)],
              "sha3": [1 << e for e in range(22)]}
TREE_ROW = 1 << 20
# hash -> (leaf shapes, merge pairs, seed of the random inputs, the lines
# of certificate_stark_tpu/engine/hasher.py that the leaf and merge kernels
# replace)
HASH_CHECKS = {"blake3": (LEAF_SHAPES, B3_MERGE_PAIRS, 11, (115, 120)),
               "sha256": (SHA_LEAF_SHAPES, MERGE_PAIRS, 17, (76, 85)),
               "sha3": (SHA_LEAF_SHAPES, MERGE_PAIRS, 19, (150, 155))}
# Seeded random inputs on which the trace kernel is held against its plain
# version beside the main path's witness: (transactions, depth, b3 form);
# one plain call each (~20 s on the card)
TRACE_CASES = ((1, 1, "full_fp6"), (33, 15, "subfield"), (33, 15, "fp2"),
               (33, 15, "full_fp6"))
TRACE_SIZES = ((1, 1), (1, 15), (128, 1), (128, 15))
TRACE_BITS = ("path_bits", "sbits", "hbits", "dbits", "gbits")
# dependent Montgomery multiplies of one Rescue round: x^3 (a squaring, a
# multiply), the inverse s-box chain, and one reduction for each MDS layer
RESCUE_DEPTH = 2 + INV_ALPHA_SQR + INV_ALPHA_MUL + 2
TX_GOLDENS = ("transaction_2tx_d3_rescue", "transaction_2tx_d3_blake3",
              "transaction_16tx_d15_blake3", "transaction_2tx_d3_cubic_blake3",
              "transaction_16tx_d15_cubic_blake3_grind12",
              "transaction_2tx_d3_sha256", "transaction_2tx_d3_sha3",
              "transaction_16tx_d15_sha3")
# rescue chain 16 goldens: name -> (vector file, options where the file
# does not hold them)
CHAIN16_GOLDENS = {
    "rescue_chain16_rescue": ("transcripts.json", dict(
        num_queries=14, blowup=4, hash_fn="rescue")),
    "rescue_chain16_cubic_grind4": ("transcripts.json", dict(
        num_queries=8, blowup=4, hash_fn="blake3", extension_degree=3,
        grinding_bits=4)),
    "rescue_chain16_quadratic_rescue_grind11": ("torch_goldens.json", None),
    "rescue_chain16_sha256": ("torch_goldens.json", None),
    "rescue_chain16_sha3": ("torch_goldens.json", None),
    "rescue_chain16_sha256_grind12": ("torch_goldens.json", None),
}
# the standalone AIRs' goldens: name -> (vector file, options where the
# file does not hold them); and the unit count of their 128-unit paths
SUBAIR_GOLDENS = {
    "range_64bit": ("transcripts.json", dict(num_queries=14, blowup=8,
                                             hash_fn="blake3")),
    "range_64bit_rescue": ("torch_goldens.json", None),
    "merkle_init_rescue": ("torch_goldens.json", None),
    "merkle_update_1tx_d3_blake3": ("torch_goldens.json", None),
    "merkle_update_16tx_d15_blake3": ("torch_goldens.json", None),
    "schnorr_2sig_blake3": ("torch_goldens.json", None),
    "schnorr_16sig_blake3": ("torch_goldens.json", None),
}
SUBAIR_UNITS = 128
# the example CLI's defaults (certificate_stark_tpu_torch/examples/
# state_transition.py): bench.py's options over the cubic extension
CLI_OPTS = dict(BENCH_OPTS, extension_degree=3)
EXT_POINTS = 1 << 20       # extension checks: [d, 2^20]
GRIND_CASES = (("blake3", 12), ("blake3", 16), ("rescue", 12), ("rescue", 16),
               ("sha256", 12), ("sha3", 12))
# the goldens proven with a checkpoint directory and resumed on the card
CHECKPOINT_GOLDENS = ("transaction_16tx_d15_blake3", "rescue_chain1024_rescue")
HOST_SCAN_CHUNK = 2048     # nonces a host-loop worker checks at a time
# Batch sizes at which the Rescue kernel is checked and timed: every size a
# chain-1024 proof launches (2^0 .. 2^15) and ragged ones
RESCUE_SIZES = sorted({1, 3, 33, 1000} | {1 << k for k in range(17)})
# Loop trip counts of each Rescue kernel's SASS, outermost loop first, and
# the share of the innermost loop's iterations that run a block it can
# skip; with threads per state, for the count of instructions per
# permutation. rescue_perm_kernel is the earlier one-state-a-thread kernel
# with a square-and-multiply inverse s-box, for `--rescue` runs on older
# checkouts.
SASS_LOOPS = {
    "rescue_perm_kernel": dict(trips=[7, 61], taken=32 / 61, threads=1),
    "rescue_perm_group": dict(trips=[7, 6], taken=1.0, threads=16),
}
OUT = os.path.join(ROOT, "build")           # git-ignored: the profile trace


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def graph_ms(fn, reps):
    """Device time of one fn() from a CUDA graph of `reps` calls, which
    replays the launches with no host work between them (captured after a
    warm-up on the capture stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(reps):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    ms = cuda_ms(g.replay, 5) / reps
    del g
    return ms


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_err(got, plain_of, n, per=1):
    """max |got - the plain version| over an input axis of n columns, the
    plain version run on slices of PLAIN_SLICE * per input columns
    (`plain_of(slice)`; `per` input columns to an output column)."""
    err, step = 0, PLAIN_SLICE * per
    for i in range(0, n, step):
        exp = plain_of(slice(i, i + step))
        o = i // per
        err = max(err, int((got[..., o:o + exp.shape[-1]] - exp)
                           .abs().max()))
    return err


def bound_ms(nbytes, muls, int8_ops=0):
    """The least time for nbytes of traffic, muls 32-bit integer
    multiplies and int8_ops tensor-core operations: the largest of the
    three times, and whether bytes or operations set it."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = max(muls / INT32_MUL_PER_S, int8_ops / INT8_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_versions():
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    from certificate_stark_tpu_torch.ops import kernels as K
    out = subprocess.run([K._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log("nvcc", out[-1])


def phase_build():
    """Builds every kernel, and the latency probe beside them; returns the
    probe's (process, library)."""
    from certificate_stark_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    probe = _probe_start()
    paths = K.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in open(path + ".log").read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return probe


def _randoms(dev):
    """rand(*shape): uniform field elements on the card, from a seed."""
    from certificate_stark_tpu_torch.ops import field as F
    g = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return torch.randint(0, F.P, shape, generator=g, device=dev,
                             dtype=torch.int64)
    return rand


def phase_kernels(dev):
    """Each kernel against its plain version on the card, bit for bit."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.ops import field as F
    P = F.P
    rand = _randoms(dev)
    rows = []
    # f63_mul: 2^24 random values plus the edge values, then F63_SIZES
    edge = torch.tensor([0, 1, P - 1, P - 2, 1 << 32, (1 << 63) % P],
                        dtype=torch.int64, device=dev)
    a = torch.cat([rand(1 << 24), edge.repeat_interleave(6)])
    b = torch.cat([rand(1 << 24), edge.repeat(6)])
    got, exp = K.f63_mul(a, b), K.mul_plain(a, b)
    err = int((got - exp).abs().max())
    check(err == 0, "f63_mul differs from its plain version at 2^24")
    ms_by_n, bound_by_n = {}, {}
    for n in F63_SIZES:
        a, b = rand(n), rand(n)
        got = K.f63_mul(a, b)
        err = max(err, plain_err(got, lambda s: K.mul_plain(a[s], b[s]), n))
        check(err == 0, f"f63_mul differs from its plain version at [{n}]")
        del got
        ms_by_n[n] = cuda_ms(lambda: K.f63_mul(a, b), 20)
        bound_by_n[n] = bound_ms(24 * n, n * MULS_PER_MMUL)[0]
        log(f"f63_mul [{n}]: {ms_by_n[n]:.4f} ms, bound "
            f"{bound_by_n[n]:.4f} ms")
        del a, b
    n = F63_ROW
    a, b = rand(n), rand(n)
    plain = cuda_ms(lambda: K.mul_plain(a, b), 2)
    bnd, by = bound_ms(24 * n, n * MULS_PER_MMUL)
    log(f"f63_mul [{n}]: {ms_by_n[n]:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bnd:.4f} ms ({by})")
    rows.append(dict(name="f63_mul", route="cuda",
                     source="certificate_stark_tpu_torch/csrc/f63_mul.cu",
                     replaces="certificate_stark_tpu/ops/pallas_kernels.py:177",
                     max_abs_err=err, ms=ms_by_n[n], plain_ms=plain,
                     bound_ms=bnd, bound_by=by, library_ms=None, shape=[n],
                     ms_by_n=ms_by_n, bound_ms_by_n=bound_by_n))
    del a, b

    rows.append(phase_rescue(dev, rand))
    return rows


def phase_rescue(dev, rand):
    """rescue_permutation against its plain version at every size of
    RESCUE_SIZES, and its time at each; the row is the main path's
    leaf-hashing batch [14, 2^15]."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.ops import rescue as R
    mds, _, ark = R.tables(dev)
    err, ms_by_n = 0, {}
    for nstates in RESCUE_SIZES:
        st = rand(14, nstates)
        exp = K.rescue_permutation_plain(st, mds, ark)
        got = K.rescue_permutation(st, mds, ark)
        err = max(err, int((got - exp).abs().max()))
        check(err == 0, f"rescue_permutation differs at [14, {nstates}]")
        ms_by_n[nstates] = cuda_ms(
            lambda: K.rescue_permutation(st, mds, ark), 20)
        log(f"rescue_permutation [14, {nstates}]: {ms_by_n[nstates]:.4f} ms")
    nstates = 1 << 15
    st = rand(14, nstates)
    plain = cuda_ms(lambda: K.rescue_permutation_plain(st, mds, ark), 2)
    bnd, by = bound_ms(2 * 14 * 8 * nstates, nstates * MULS_PER_PERM)
    log(f"rescue_permutation [14, {nstates}]: plain {plain:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}, {MULS_PER_PERM} 32-bit multiplies a state)")
    return dict(name="rescue_permutation", route="cuda",
                source="certificate_stark_tpu_torch/csrc/rescue_perm.cu",
                replaces="certificate_stark_tpu/ops/pallas_kernels.py:143",
                max_abs_err=err, ms=ms_by_n[nstates], plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None,
                shape=[14, nstates], ms_by_n=ms_by_n)


def _sass(path):
    """{kernel function: [(address, instruction)]} of a built library, from
    cuobjdump -sass; NOPs left out."""
    from certificate_stark_tpu_torch.ops import kernels as K
    exe = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    out = subprocess.run([exe, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None and not m.group(2).startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _sass_executed(instrs, trips, taken):
    """Instructions one thread executes: each weighted by the trip counts
    of the loops (backward branches) around it, outermost first, and a
    range that a forward branch inside the innermost loop skips by
    `taken`; and of them the IMAD instructions (the multiply-add pipe).
    None when the loops found are not the ones expected."""
    loops, skips = [], []
    for addr, ins in instrs:
        m = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)
        if not m:
            continue
        tgt = int(m.group(1), 16)
        if tgt < addr:
            loops.append((tgt, addr))
        elif tgt > addr and ins.startswith("@"):
            skips.append((addr, tgt))
    loops.sort()
    if len(loops) != len(trips):
        return None, None, loops, skips
    inner = loops[-1]
    skips = [(a, t) for a, t in skips if inner[0] <= a and t <= inner[1]]
    total = imad = 0.0
    for addr, ins in instrs:
        w = 1.0
        for (lo, hi), n in zip(loops, trips):
            if lo <= addr <= hi:
                w *= n
        if any(a < addr < t for a, t in skips):
            w *= taken
        total += w
        if re.sub(r"^@!?U?P\w+\s+", "", ins).startswith("IMAD"):
            imad += w
    return total, imad, loops, skips


def _hot_loop(instrs):
    """Of the loops (backward branches) that hold no other loop, the one
    with the most 32 x 32 + 64-bit multiply-adds (IMAD.WIDE): its
    instruction count and its mix of multiply-adds, register moves and
    shared-memory loads."""
    loops = [(int(m.group(1), 16), addr) for addr, ins in instrs
             for m in [re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)]
             if m and int(m.group(1), 16) < addr]
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b in loops)]
    best = None
    for lo, hi in inner:
        ops = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
               for addr, ins in instrs if lo <= addr <= hi]
        mix = dict(instructions=len(ops),
                   imad_wide=sum(o.startswith("IMAD.WIDE") for o in ops),
                   moves=sum(o in ("MOV", "IMAD.MOV.U32") for o in ops),
                   shared_loads=sum(o.startswith("LDS") for o in ops))
        if best is None or mix["imad_wide"] > best["imad_wide"]:
            best = mix
    return best


def _mma_mix(instrs):
    """Static counts of a kernel's integer tensor-core (IMMA) and
    multiply-add (IMAD) instructions, and of the innermost loop with the
    most IMMA: its instructions, IMMA, IMAD, PRMT and shared loads."""
    ops = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
           for _, ins in instrs]
    mix = dict(imma=sum(o.startswith("IMMA") for o in ops),
               imad=sum(o.startswith("IMAD") for o in ops))
    loops = [(int(m.group(1), 16), addr) for addr, ins in instrs
             for m in [re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)]
             if m and int(m.group(1), 16) < addr]
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b in loops)]
    for lo, hi in inner:
        body = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
                for addr, ins in instrs if lo <= addr <= hi]
        loop = dict(instructions=len(body),
                    imma=sum(o.startswith("IMMA") for o in body),
                    imad=sum(o.startswith("IMAD") for o in body),
                    prmt=sum(o.startswith("PRMT") for o in body),
                    shared_loads=sum(o.startswith("LDS") for o in body))
        if loop["imma"] > mix.get("loop", {}).get("imma", 0):
            mix["loop"] = loop
    return mix


def phase_sass():
    """Static SASS instruction counts of every kernel, the Rescue kernels'
    instructions per permutation (per thread x threads a state), the
    composition kernels' hottest loop (a run of FOLD_EVERY items), and the
    tail's tensor-core kernels' IMMA and IMAD counts (`_mma_mix`; their
    registers in the ptxas lines of phase_build and phase_tail)."""
    from certificate_stark_tpu_torch.ops import kernels as K
    out = {}
    for name, path in K.build().items():
        for func, instrs in _sass(path).items():
            line = f"sass {func}: {len(instrs)} instructions (static)"
            for key, spec in SASS_LOOPS.items():
                if key not in func:
                    continue
                per_thread, imad, loops, skips = _sass_executed(
                    instrs, spec["trips"], spec["taken"])
                if per_thread is None:
                    bras = [i for _, i in instrs if "BRA" in i][:4]
                    line += (f"; loops {[hex(a) for a, _ in loops]} are not "
                             f"the {len(spec['trips'])} expected: not counted "
                             f"(branches {bras})")
                else:
                    per_perm = per_thread * spec["threads"]
                    out[func] = per_perm
                    line += (f"; {len(loops)} loops (trips {spec['trips']}), "
                             f"{len(skips)} skipped ranges: {per_thread:.0f} "
                             f"a thread, {per_perm:.0f} a permutation, "
                             f"{100 * imad / per_thread:.1f}% IMAD")
            if "compose_kernel" in func:
                line += f"; hot loop {_hot_loop(instrs)}"
            if re.search(r"(ood|deep)_kernelILi", func):
                out[func] = _mma_mix(instrs)
                line += f"; {out[func]}"
            log(line)
    return out


def phase_profile(dev):
    """Ten warm chain-1024 proofs timed on the host clock, then one under
    torch.profiler (CUDA activity): device time by kernel name, the Rescue
    kernels' share, and the device's busy share of the proof's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        golden = json.load(f)["rescue_chain1024_rescue"]
    ex = RC.RescueChainExample(1024, ProofOptions(**golden["options"]),
                               device=dev)
    prover = Prover(ex.air(), device=dev)
    prover.prove(ex.trace)                                  # warm-up
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prover.prove(ex.trace)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.prove(ex.trace)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, rescue_grids = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    os.makedirs(OUT, exist_ok=True)
    trace_path = os.path.join(OUT, "chain1024_profile.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        for ev in json.load(f).get("traceEvents", []):
            if ev.get("cat") == "kernel" and "rescue_perm" in ev["name"]:
                key = str(ev.get("args", {}).get("grid"))
                rescue_grids[key] = rescue_grids.get(key, 0) + 1
    device_ms = sum(t for t, _ in by_name.values())
    rescue = [(n, t, c) for n, (t, c) in by_name.items() if "rescue_perm" in n]
    rescue_ms = sum(t for _, t, _ in rescue)
    log(f"chain 1024 warm proof (trace built beforehand), {len(walls)} "
        f"runs: median {sorted(walls)[len(walls) // 2]:.1f} ms, min "
        f"{min(walls):.1f} ms, max {max(walls):.1f} ms")
    log(f"profile, chain 1024 warm proof (trace built beforehand): wall "
        f"{wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
        f"({100 * device_ms / wall_ms:.1f}%), Rescue kernels "
        f"{rescue_ms:.3f} ms in {sum(c for *_, c in rescue)} launches")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {t:9.3f} ms {c:5d}x {name[:90]}")
    log(f"  Rescue launches by grid: {rescue_grids}")
    return dict(walls_ms=walls, profiled_wall_ms=wall_ms,
                device_ms=device_ms, rescue_ms=rescue_ms)


def _prove(chain, opts, dev, mark=None):
    """The user's path: example (trace + public inputs) -> Prover.prove."""
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    ex = RC.RescueChainExample(chain, opts, device=dev)
    prover = Prover(ex.air(), device=dev)
    prover.coin_journal = []
    return prover, prover.prove(ex.trace, mark=mark)


def _golden_check(name, golden, prover, proof):
    raw = proof.to_bytes()
    journal = [[kind, val] for kind, val in prover.coin_journal]
    check(journal == golden["journal"], f"{name}: coin journal differs")
    sha = hashlib.sha256(raw).hexdigest()
    check(sha == golden["proof_sha256"] and len(raw) == golden["proof_len"],
          f"{name}: proof {sha} ({len(raw)} B) != golden "
          f"{golden['proof_sha256']} ({golden['proof_len']} B)")
    log(f"{name}: journal ({len(journal)} events) and proof sha256 "
        f"{sha[:16]}... ({len(raw)} B) equal the golden")


def phase_golden16(dev):
    """The rescue chain 16 goldens: the base field with Rescue
    commitments, the cubic extension with BLAKE3 and 4-bit grinding, the
    quadratic extension with Rescue commitments and 11-bit Rescue grinding
    (the batched search on the card)."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    for name, (path, od) in CHAIN16_GOLDENS.items():
        with open(os.path.join(ROOT, "tests", "vectors", path)) as f:
            golden = json.load(f)[name]
        opts = ProofOptions(**(od or golden["options"]))
        _golden_check(name, golden, *_prove(16, opts, dev))


def phase_ext(dev):
    """ext_mul, ext_mul_sum and ext_inv_vec at d = 2 and 3 on the card (its
    base products on f63_mul) against the same functions on the CPU (the
    plain versions), bit for bit: operands [d, 2^20]; ext_mul_sum sums
    [d, 8, 2^17] over its 8 rows against [d, 8, 1] coefficients, as DEEP
    sums the composition columns. Each is timed on the card."""
    from certificate_stark_tpu_torch.ops import extfield as XF
    from certificate_stark_tpu_torch.ops import field as F
    g = torch.Generator().manual_seed(13)

    def rand(*shape):
        return torch.randint(0, F.P, shape, generator=g, dtype=torch.int64)
    out = {}
    for d in (2, 3):
        a, b = rand(d, EXT_POINTS), rand(d, EXT_POINTS)
        rows, coeffs = rand(d, 8, EXT_POINTS // 8), rand(d, 8, 1)
        cases = {
            "ext_mul": (lambda x, y: XF.ext_mul(x, y, d), (a, b)),
            "ext_mul_sum": (lambda x, y: XF.ext_mul_sum(x, y, d, dim=1),
                            (rows, coeffs)),
            "ext_inv_vec": (lambda x: XF.ext_inv_vec(x, d), (a,)),
        }
        for name, (fn, args) in cases.items():
            exp = fn(*args)
            on_card = [t.to(dev) for t in args]
            check(torch.equal(fn(*on_card).cpu(), exp),
                  f"{name} (d = {d}) on the card differs from the CPU")
            out[f"{name}_d{d}"] = cuda_ms(lambda: fn(*on_card), 5)
    log("extension ops on the card == CPU at [d, 2^20]; ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


def _host_scan(args):
    """The first nonce in [lo, hi) that the coin's PoW check passes (the
    host loop of RandomCoin.grind), or None. Runs in a worker process."""
    from certificate_stark_tpu_torch.engine.coin import RandomCoin
    from certificate_stark_tpu_torch.engine.hasher import get_hasher
    hash_fn, state, bits, lo, hi = args
    coin = RandomCoin(get_hasher(hash_fn), [0])
    coin.state = tuple(state)
    return next((n for n in range(lo, hi) if coin.check_pow(n, bits)), None)


def phase_grind(dev):
    """The batched PoW search on the card (one merge of the byte hasher or
    one Rescue digest a batch of 2^15 nonces) at 12 and 16 bits for BLAKE3
    and Rescue and at 12 bits for SHA-256 and SHA3-256, timed, against the
    host loop over every nonce up to the one it returns (in worker
    processes, one per CPU core). Returns each search's launch counts."""
    import multiprocessing
    from certificate_stark_tpu_torch.engine.coin import RandomCoin
    from certificate_stark_tpu_torch.engine.hasher import get_hasher
    from certificate_stark_tpu_torch.ops import kernels as K
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(os.cpu_count(),
                                                mp_context=ctx) as pool:
        for hash_fn, bits in GRIND_CASES:
            h = get_hasher(hash_fn)
            coin = RandomCoin(h, [3, 1, 4, 1, 5])
            coin.reseed(h.host_digest([9, 2, 6, bits]))
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nonce = coin.grind(bits, device=dev)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            kernel = {"blake3": K.blake3_merge, "sha256": K.sha256_merge,
                      "sha3": K.sha3_merge,
                      "rescue": K.rescue_permutation}[hash_fn]
            check(kernel.launches > 0, f"{hash_fn} grinding launched no "
                  f"{kernel.__name__}")
            t0 = time.perf_counter()
            jobs = [(hash_fn, coin.state, bits, lo,
                     min(lo + HOST_SCAN_CHUNK, nonce + 1))
                    for lo in range(0, nonce + 1, HOST_SCAN_CHUNK)]
            host = next(n for n in pool.map(_host_scan, jobs)
                        if n is not None)
            check(host == nonce, f"{hash_fn} {bits}-bit grinding: the card "
                  f"found {nonce}, the host loop {host}")
            out[f"grind_{hash_fn}_{bits}"] = {
                fn.__name__: fn.launches for fn in K.WRAPPERS}
            log(f"grind {hash_fn} {bits} bits on the card: nonce {nonce} "
                f"(= host loop, {time.perf_counter() - t0:.1f} s on "
                f"{os.cpu_count()} processes) in {ms:.2f} ms, "
                f"{kernel.launches} {kernel.__name__} launches")
    return out


def phase_full(dev):
    """Chain 1024 (trace 14 x 8192, LDE 2^15): warm-up, then the counted and
    timed main-path run, build_trace included as bench.py times it."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    from certificate_stark_tpu_torch.ops import kernels as K
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        golden = json.load(f)["rescue_chain1024_rescue"]
    opts = ProofOptions(**golden["options"])
    ex = RC.RescueChainExample(1024, opts, device=dev)
    check(ex.result == golden["result"], "chain-1024 result differs")
    prover = Prover(ex.air(), device=dev)
    prover.prove(ex.trace)                                  # warm-up

    spans = []
    t_last = [0.0]

    def mark(label):
        torch.cuda.synchronize()
        now = time.perf_counter()
        spans.append((label, (now - t_last[0]) * 1e3))
        t_last[0] = now

    prover.coin_journal = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = t_last[0] = time.perf_counter()
    trace = RC.build_trace(ex.seed, 1024, dev)
    mark("build_trace (host)")
    proof = prover.prove(trace, mark=mark)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in K.WRAPPERS}
    log(f"chain 1024 prove wall (build_trace included): {wall * 1e3:.1f} ms")
    for label, ms in spans:
        log(f"  {label:32s} {ms:10.1f} ms")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        f" MiB; kernel launches {launches}")
    for name in ("f63_mul", "rescue_permutation", "ntt", "lde"):
        check(launches[name] > 0, f"{name} was not launched on the chain "
              "main path")
    _check_tail(launches, prover.bn // prover.chunk, len(proof.fri_roots),
                "chain 1024")
    _golden_check("rescue_chain1024_rescue", golden, prover, proof)
    return launches, ex, proof


def phase_scale(dev):
    """Chain 8192 (trace 14 x 2^16, LDE 2^18): kernels and plain versions
    must give the same proof bytes."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    from certificate_stark_tpu_torch.ops import kernels as K
    opts = ProofOptions(num_queries=42, blowup=4, hash_fn="rescue",
                        fri_folding=4, fri_max_remainder=256)
    ex = RC.RescueChainExample(8192, opts, device=dev)
    prover = Prover(ex.air(), device=dev)
    out = {}
    for label in ("kernels", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "plain":
            with K.plain_versions():
                proof = prover.prove(ex.trace)
        else:
            proof = prover.prove(ex.trace)
        torch.cuda.synchronize()
        out[label] = proof.to_bytes()
        log(f"chain 8192 prove with {label}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"(trace built beforehand), {len(out[label])} B")
    check(out["kernels"] == out["plain"],
          "chain 8192: the proof with kernels differs from the plain one")
    log("chain 8192: proofs with kernels and with plain versions are equal, "
        f"sha256 {hashlib.sha256(out['kernels']).hexdigest()[:16]}...")


def _keccak_ops():
    """32-bit integer instructions of one Keccak-f[1600] permutation."""
    from certificate_stark_tpu_torch.ops.sha3 import RC
    return 24 * KECCAK_ROUND_OPS + sum(
        (c & 0xFFFFFFFF != 0) + (c >> 32 != 0) for c in RC)


def _leaf_ops(hash_fn, k):
    """32-bit integer instructions of one leaf hash of k elements: the
    compressions or permutations, for SHA the byte swaps or absorbing xors
    of the message words, and one REDC an element."""
    if hash_fn == "blake3":
        return (8 * k + 63) // 64 * BLAKE3_OPS + k * REDC_OPS
    if hash_fn == "sha256":
        return (2 * k + 18) // 16 * SHA256_OPS + 2 * k + k * REDC_OPS
    return (k // 17 + 1) * _keccak_ops() + 2 * k + 2 + k * REDC_OPS


def _merge_ops(hash_fn):
    """32-bit integer instructions of one merge of two digests."""
    return dict(blake3=BLAKE3_OPS, sha256=SHA256_MERGE_OPS,
                sha3=_keccak_ops())[hash_fn]


def phase_hashes(dev, names=tuple(HASH_CHECKS)):
    """The leaf and merge kernels of each commitment hash `names` of
    HASH_CHECKS against their plain versions on the card, bit for bit, and
    the SHA ones against hashlib on three columns: the leaves at the main
    paths' shapes and ragged ones, the merges at every level size of a
    128-transaction proof's trees (2^0 .. 2^19 pairs; BLAKE3 up to the
    1024-transaction proof's 2^22) and ragged ones. Each timed at each
    shape beside its bound; the rows are at the first leaf shape and at
    ROW_PAIRS, with each kernel's registers from the ptxas report."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.ops import sha256 as S2
    from certificate_stark_tpu_torch.ops import sha3 as S3
    # host oracle: (digest of bytes as words, byte order of a word)
    oracles = dict(sha256=(S2.digest_words, "big"),
                   sha3=(S3.digest_words, "little"))
    one = torch.ones((), dtype=torch.int64)
    rows = []
    for hash_fn in names:
        shapes, pairs, seed, lines = HASH_CHECKS[hash_fn]
        g = torch.Generator(device=dev).manual_seed(seed)
        digest, order = oracles.get(hash_fn, (None, None))
        also = "; equal to hashlib on 3 {} of every {}" if digest else ""
        leaves = getattr(K, f"{hash_fn}_leaves")
        leaves_plain = getattr(K, f"{hash_fn}_leaves_plain")
        merge = getattr(K, f"{hash_fn}_merge")
        merge_plain = getattr(K, f"{hash_fn}_merge_plain")
        source = f"certificate_stark_tpu_torch/csrc/{hash_fn}.cu"
        err, ms, bnds = 0, {}, {}
        for k, b in shapes:
            x = torch.randint(0, F.P, (k, b), generator=g, device=dev,
                              dtype=torch.int64)
            got = leaves(x)
            err = max(err, plain_err(got, lambda s: leaves_plain(x[:, s]),
                                     b))
            check(err == 0, f"{leaves.__name__} differs from its plain "
                  f"version at [{k}, {b}]")
            if digest:
                cols = sorted({0, b // 2, b - 1})
                std = K.mul_plain(x[:, cols].cpu(), one)
                for i, j in enumerate(cols):
                    data = b"".join(int(v).to_bytes(8, "little")
                                    for v in std[:, i].tolist())
                    check(tuple(got[:, j].tolist()) == digest(data),
                          f"{leaves.__name__} differs from hashlib at "
                          f"[{k}, {b}] column {j}")
            key = f"{k}x{b}"
            ms[key] = cuda_ms(lambda: leaves(x), 10)
            bnds[key] = bound_ms(8 * k * b + 64 * b,
                                 b * _leaf_ops(hash_fn, k))[0]
            log(f"{leaves.__name__} [{k}, {b}]: {ms[key]:.4f} ms, bound "
                f"{bnds[key]:.4f} ms")
            del got, x
        k, b = shapes[0]
        x = torch.randint(0, F.P, (k, b), generator=g, device=dev,
                          dtype=torch.int64)
        plain = cuda_ms(lambda: leaves_plain(x), 2)
        bnd, by = bound_ms(8 * k * b + 64 * b, b * _leaf_ops(hash_fn, k))
        log(f"{leaves.__name__} [{k}, {b}]: plain {plain:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}, {_leaf_ops(hash_fn, k)} 32-bit integer "
            f"instructions a leaf)" + also.format("columns", "shape"))
        rows.append(dict(
            name=leaves.__name__, route="cuda", source=source,
            replaces=f"certificate_stark_tpu/engine/hasher.py:{lines[0]}",
            max_abs_err=err, ms=ms[f"{k}x{b}"], plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=None, shape=[k, b],
            ms_by_shape=ms, bound_ms_by_shape=bnds,
            **_ptxas_usage(hash_fn, f"{hash_fn}_leaves_kernel")))
        del x
        err, ms, bnds = 0, {}, {}
        for m in pairs:
            lvl = torch.randint(0, 1 << 32, (8, 2 * m), generator=g,
                                device=dev, dtype=torch.int64)
            got = merge(lvl)
            err = max(err, plain_err(got, lambda s: merge_plain(lvl[:, s]),
                                     2 * m, per=2))
            check(err == 0, f"{merge.__name__} differs at {m} pairs")
            for j in sorted({0, m // 2, m - 1}) if digest else ():
                words = lvl[:, 2 * j].tolist() + lvl[:, 2 * j + 1].tolist()
                data = b"".join(int(w).to_bytes(4, order) for w in words)
                check(tuple(got[:, j].tolist()) == digest(data),
                      f"{merge.__name__} differs from hashlib at {m} pairs, "
                      f"pair {j}")
            ms[m] = cuda_ms(lambda: merge(lvl), 10)
            bnds[m] = bound_ms(16 * m * 8 + 8 * m * 8,
                               m * _merge_ops(hash_fn))[0]
        log(f"{merge.__name__} ms by pairs: " + ", ".join(
            f"{m}: {t:.4f} (bound {bnds[m]:.5f})" for m, t in ms.items()))
        m = ROW_PAIRS
        lvl = torch.randint(0, 1 << 32, (8, 2 * m), generator=g, device=dev,
                            dtype=torch.int64)
        plain = cuda_ms(lambda: merge_plain(lvl), 2)
        bnd, by = bound_ms(16 * m * 8 + 8 * m * 8, m * _merge_ops(hash_fn))
        log(f"{merge.__name__} [8, {2 * m}]: plain {plain:.4f} ms, bound "
            f"{bnd:.4f} ms ({by})" + also.format("pairs", "size"))
        rows.append(dict(
            name=merge.__name__, route="cuda", source=source,
            replaces=f"certificate_stark_tpu/engine/hasher.py:{lines[1]}",
            max_abs_err=err, ms=ms[m], plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=None, shape=[8, 2 * m], ms_by_pairs=ms,
            bound_ms_by_pairs=bnds,
            **_ptxas_usage(hash_fn, f"{hash_fn}_merge_kernel")))
    return rows


def _tree_loop(merge, leaves):
    """The trees before the tree kernels: one merge launch a level."""
    level = leaves
    while level.shape[1] > 1:
        level = merge(level)
    return level


def phase_trees(dev):
    """The tree kernels (blake3_tree, sha256_tree, sha3_tree) against
    tree_plain on the card, bit for bit on every level, at every leaf count
    of TREE_SIZES: one launch a tree (none for one leaf). Each size's
    leaves are the first columns of one seeded random [8, max] tensor, so
    a size's levels are the first digests of the levels of the largest
    size's plain tree. Each size timed (CUDA events) beside the whole
    tree's bound (the leaves read and n - 1 digests written once; n - 1
    merges) and beside the per-level loop of the merge kernel it replaces,
    on the same leaves: each call as the prover makes it (host work
    included), and on the device alone (a CUDA graph of the calls).
    Returns the kernels line's rows, at TREE_ROW leaves, with the kernel's
    registers and shared memory from the ptxas report."""
    from certificate_stark_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    rows = []
    for hash_fn, sizes in TREE_SIZES.items():
        tree = getattr(K, f"{hash_fn}_tree")
        merge = getattr(K, f"{hash_fn}_merge")
        merge_plain = getattr(K, f"{hash_fn}_merge_plain")
        g = torch.Generator(device=dev).manual_seed(23)
        leaves = torch.randint(0, 1 << 32, (8, max(sizes)), generator=g,
                               device=dev, dtype=torch.int64)
        plain = K.tree_levels_of(K.tree_plain(merge_plain, leaves))
        err, ms, loop, dev_ms, dev_loop, bnds = 0, {}, {}, {}, {}, {}
        for n in sizes:
            x = leaves[:, :n].contiguous()
            before = tree.launches
            got = K.tree_levels_of(tree(x))
            check(tree.launches - before == (n > 1),
                  f"{tree.__name__}: not one launch at {n} leaves")
            check(len(got) == n.bit_length() - 1,
                  f"{tree.__name__}: {len(got)} levels at {n} leaves")
            for lvl, (a, b) in enumerate(zip(got, plain), 1):
                err = max(err, int((a - b[:, :a.shape[1]]).abs().max()))
                check(err == 0, f"{tree.__name__} differs from tree_plain "
                      f"at {n} leaves, level {lvl}")
            del got
            ms[n] = cuda_ms(lambda: tree(x), 10)
            loop[n] = cuda_ms(lambda: _tree_loop(merge, x), 10)
            # one leaf: no launch, nothing for a graph to time
            dev_ms[n] = graph_ms(lambda: tree(x), 10) if n > 1 else 0.0
            dev_loop[n] = (graph_ms(lambda: _tree_loop(merge, x), 10)
                           if n > 1 else 0.0)
            bnds[n] = bound_ms(8 * 8 * (2 * n - 1),
                               (n - 1) * _merge_ops(hash_fn))[0]
        log(f"{tree.__name__} ms by leaves, a call (the per-level "
            f"{merge.__name__} loop), on the device alone (the loop); "
            "bound: " + ", ".join(
                f"{n}: {ms[n]:.4f} ({loop[n]:.4f}), {dev_ms[n]:.4f} "
                f"({dev_loop[n]:.4f}); {bnds[n]:.5f}" for n in sizes))
        del plain
        n = TREE_ROW
        x = leaves[:, :n].contiguous()
        plain_ms = cuda_ms(lambda: K.tree_plain(merge_plain, x), 2)
        bnd, by = bound_ms(8 * 8 * (2 * n - 1), (n - 1) * _merge_ops(hash_fn))
        use = _ptxas_usage(hash_fn, f"{hash_fn}_tree_kernel")
        log(f"{tree.__name__} [8, {n}]: {ms[n]:.4f} ms, per-level loop "
            f"{loop[n]:.4f} ms; device alone {dev_ms[n]:.4f}, loop "
            f"{dev_loop[n]:.4f}; plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by}); {use}")
        rows.append(dict(
            name=tree.__name__, route="cuda",
            source=f"certificate_stark_tpu_torch/csrc/{hash_fn}.cu",
            replaces="certificate_stark_tpu/engine/kernels.py:22",
            max_abs_err=err, ms=ms[n], plain_ms=plain_ms, bound_ms=bnd,
            bound_by=by, library_ms=None, shape=[8, n], ms_by_leaves=ms,
            loop_ms_by_leaves=loop, device_ms_by_leaves=dev_ms,
            loop_device_ms_by_leaves=dev_loop, bound_ms_by_leaves=bnds,
            **use))
        del leaves, x
    log(f"phase_trees: {time.perf_counter() - t0:.1f} s")
    return rows


def _trace_muls(inputs, depth, b3):
    """32-bit multiplies of csrc/tx_trace.cu for these inputs: the Rescue
    rounds, both scalar multiplications' doublings, the mixed additions of
    the bits that are set, the final addition and the fp6 inverse."""
    b3m = (6 if not any(b3[1:]) else 9 if not any(b3[2:]) else 18) \
        * MULS_PER_MMUL
    T = inputs["init"].shape[0]
    rounds = 4 * 7 * (depth + 1) + 7 * 5
    bits = int(inputs["sbits"][:, :255].sum()) + \
        int(inputs["hbits"][:, :255].sum())
    per_double = 11 * MULS_PER_F6MUL + 2 * b3m
    per_add = 11 * MULS_PER_F6MUL + 2 * b3m
    fixed = (rounds * MULS_PER_ROUND + 2 * 255 * per_double
             + 12 * MULS_PER_F6MUL + 2 * b3m
             + F6_INV_MMULS * MULS_PER_MMUL + MULS_PER_F6MUL)
    return T * fixed + bits * per_add


def _trace_chain(inputs, depth):
    """The longest chain of dependent Montgomery multiplies in one
    transaction window of csrc/tx_trace.cu, over the lanes that run side by
    side, for these inputs: (chain, lane). A Rescue round is RESCUE_DEPTH
    deep; a doubling, a mixed addition and the final addition each add 3 to
    a point's depth (their products read sums of the point's coordinates, a
    product of products at most twice more); the fp6 inverse adds 3 to its
    fp2 norm, the base-field inverse's chain and 2 more; the affine x 1."""
    merkle = 7 * (depth + 1) * RESCUE_DEPTH
    hashl = 7 * 5 * RESCUE_DEPTH
    pop = torch.maximum(inputs["sbits"][:, :255].sum(1),
                        inputs["hbits"][:, :255].sum(1))
    ec = 3 * 255 + 3 * int(pop.max()) + 3 + (3 + P_INV_MMULS + 2) + 1
    return max((merkle, "Merkle"), (hashl, "hash"), (ec, "EC"))


PROBE_SRC = r"""
#include <cuda_runtime.h>
#include "f63.cuh"
// one thread: n dependent Montgomery multiplies
__global__ void f63_chain(u64* out, u64 x, u64 y, long long n) {
#pragma unroll 8
    for (long long i = 0; i < n; i++) x = f63_mmul(x, y);
    *out = x;
}
extern "C" int f63_chain_launch(void* out, long long n, void* stream) {
    f63_chain<<<1, 1, 0, (cudaStream_t)stream>>>(
        (u64*)out, 1234567891011ULL, 987654321987ULL, n);
    return (int)cudaGetLastError();
}
"""


def _probe_start():
    """Starts nvcc on the latency probe (one thread, a chain of dependent
    f63.cuh Montgomery multiplies): (process, library path)."""
    from certificate_stark_tpu_torch.ops import kernels as K
    d = os.path.join(OUT, "probe")
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "f63_chain.cu"), os.path.join(d, "f63_chain.so")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    cmd = [K._nvcc()] + K.NVCC_FLAGS + ["-I", K.CSRC, "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), lib


def phase_latency(probe, dev):
    """ns of one dependent Montgomery multiply on one thread: the time of a
    chain of 2^18 less one of 2^16, over the 3 * 2^16 multiplies between."""
    import ctypes
    proc, lib = probe
    out = proc.communicate()[0].decode(errors="replace")
    check(proc.returncode == 0, f"latency probe does not build:\n{out}")
    fn = ctypes.CDLL(lib).f63_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = {n: cuda_ms(lambda: check(fn(buf.data_ptr(), n, stream) == 0,
                                   "latency probe launch"), 5)
          for n in (1 << 16, 1 << 18)}
    ns = (ms[1 << 18] - ms[1 << 16]) * 1e6 / (3 << 16)
    log(f"dependent Montgomery multiply on one thread: {ns:.3f} ns "
        f"({ms[1 << 16]:.4f} ms for 2^16, {ms[1 << 18]:.4f} ms for 2^18)")
    return ns


def _ptxas_usage(name, func):
    """Registers, stack frame and spill bytes a thread of kernel `func`, and
    its static shared memory a block, from the -Xptxas -v report of
    library `name`."""
    from certificate_stark_tpu_torch.ops import kernels as K
    text = open(K.build()[name] + ".log").read()
    use = {}
    for block in text.split("ptxas info    : Compiling entry function")[1:]:
        if func not in block.splitlines()[0]:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads")):
            m = re.search(pat, block)
            use[key] = int(m.group(1)) if m else None
    return use


def _b3_forms():
    """The curve constant's three forms, standard-form ints: the subfield
    and fp2 curves' b3, and a random full fp6 element (numpy seed 99)."""
    import numpy as np
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.utils import curve as CV
    rng = np.random.default_rng(99)
    full = [int(v) for v in rng.integers(0, F.P, size=6, dtype=np.uint64)]
    return {"subfield": [3 * v % F.P for v in CV._load("subfield")["b_limbs"]],
            "fp2": [3 * v % F.P for v in CV._load("fp2")["b_limbs"]],
            "full_fp6": full}


def _random_trace_inputs(T, depth, b3, seed, dev):
    """Seeded random trace inputs (numpy): random Montgomery values, random
    0/1 bits, a random gen12, the curve constant b3 (standard-form ints)."""
    import numpy as np
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.ops import rescue as R
    rng = np.random.default_rng(seed)

    def vals(shape):
        return torch.from_numpy(rng.integers(0, F.P, size=shape,
                                             dtype=np.int64)).to(dev)
    inputs = {}
    for name, shape in K.TRACE_INPUTS:
        shape = (T,) + tuple(depth if s == "d" else s for s in shape)
        inputs[name] = (torch.from_numpy(rng.integers(0, 2, size=shape))
                        .to(dev) if name in TRACE_BITS else vals(shape))
    mds, _, ark = R.tables(dev)
    consts = dict(gen12=vals((12,)), b3=F.from_ints(b3, dev), mds=mds,
                  ark=ark)
    return inputs, consts


def _trace_check(inputs, consts, depth, what):
    """The kernel against its plain version, bit for bit, and both timed:
    (plain ms, kernel ms over 10 launches)."""
    from certificate_stark_tpu_torch.models import trace_device as TD
    from certificate_stark_tpu_torch.ops import kernels as K
    got = K.transaction_trace(inputs, consts, depth)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with K.plain_versions():
        exp = TD.build_trace_plain(inputs, consts, depth)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = int((got - exp).abs().max())
    if err:
        bad = (got != exp).reshape(94, -1, 1024).nonzero()
        log(f"  {what}: {bad.shape[0]} cells differ; first (col, tx, row): "
            f"{bad[:8].tolist()}")
    check(err == 0, f"transaction_trace differs from its plain version "
          f"({what})")
    ms = cuda_ms(lambda: K.transaction_trace(inputs, consts, depth), 10)
    log(f"transaction_trace == plain ({what}): {ms:.4f} ms, plain "
        f"{plain:.1f} ms")
    return plain, ms


def phase_trace_kernel(dev, ex, latency_ns):
    """transaction_trace against its plain version bit for bit: on the main
    path's witness (128 transactions, depth 15; `ex`, or seeded random
    inputs of that size where `ex` is None) and on seeded random inputs of
    TRACE_CASES, each b3 form once at least. Then its time at the main
    path's size, its bounds (throughput; critical path: the longest chain
    of dependent multiplies times `latency_ns`) and its registers, stack and
    spills a thread."""
    from certificate_stark_tpu_torch.models import trace_device as TD
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.utils import curve as CV
    forms = _b3_forms()
    err, ms_by_case = 0, {}
    for T, depth, form in TRACE_CASES:
        inputs, consts = _random_trace_inputs(T, depth, forms[form],
                                              1000 + T, dev)
        ms_by_case[f"{T}tx_d{depth}_{form}"] = _trace_check(
            inputs, consts, depth,
            f"random, {T} tx depth {depth}, b3 {form}")[1]
    if ex is None:
        b3, depth = CV.B3_LIMBS, TX_DEPTH
        inputs, consts = _random_trace_inputs(TX_COUNT, depth, b3, 7, dev)
        what = f"random, {TX_COUNT} tx depth {depth}"
    else:
        b3, depth = CV.B3_LIMBS, ex.depth
        inputs, consts = TD.pack_witness(ex.md, ex.messages, dev)
        what = f"witness, {TX_COUNT} tx depth {depth}"
    plain, _ = _trace_check(inputs, consts, depth, what)
    got = K.transaction_trace(inputs, consts, depth)
    ms = cuda_ms(lambda: K.transaction_trace(inputs, consts, depth), 20)
    nbytes = sum(t.numel() * 8 for t in inputs.values()) + got.numel() * 8
    muls = _trace_muls(inputs, depth, b3)
    bnd, by = bound_ms(nbytes, muls)
    chain, lane = _trace_chain(inputs, depth)
    chain_ms = chain * latency_ns * 1e-6
    use = _ptxas_usage("tx_trace", "transaction_trace")
    log(f"transaction_trace [94, {got.shape[1]}] ({what}): {ms:.4f} ms, "
        f"plain {plain:.1f} ms, bound {bnd:.4f} ms ({by}, {muls} 32-bit "
        f"multiplies), critical-path bound {chain_ms:.4f} ms ({chain} "
        f"dependent multiplies, {lane} lane, x {latency_ns:.3f} ns); {use}")
    return dict(name="transaction_trace", route="cuda",
                source="certificate_stark_tpu_torch/csrc/tx_trace.cu",
                replaces="certificate_stark_tpu/models/trace_device.py:36",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, shape=list(got.shape),
                critical_path_ms=chain_ms, chain=chain, chain_lane=lane,
                latency_ns=latency_ns, ms_by_case=ms_by_case, **use)


def phase_trace_sizes(dev):
    """The trace kernel's time on seeded random inputs at 1 and 128
    transactions, depth 1 and 15: the tree depth lengthens only the Merkle
    lane, the transaction count only fills more SMs."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.utils import curve as CV
    out = {}
    for T, depth in TRACE_SIZES:
        inputs, consts = _random_trace_inputs(T, depth, CV.B3_LIMBS, 7, dev)
        out[f"{T}tx_d{depth}"] = cuda_ms(
            lambda: K.transaction_trace(inputs, consts, depth), 20)
    log("transaction_trace ms by size: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


def _trace_sha(trace):
    return hashlib.sha256(
        trace.cpu().numpy().astype("<i8").tobytes()).hexdigest()


def phase_tx_goldens(dev):
    """The transaction goldens reproduced on the card: trace, public roots,
    coin journal and proof bytes."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.utils import curve as CV
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        goldens = json.load(f)
    for name in TX_GOLDENS:
        g = goldens[name]
        CV.set_curve(g["curve"])
        t0 = time.perf_counter()
        ex = TX.TransactionExample(g["num_transactions"],
                                   ProofOptions(**g["options"]),
                                   depth=g["depth"], seed=g["seed"],
                                   device=dev)
        check([list(r) for r in ex.pub_inputs()] ==
              [g["initial_root"], g["final_root"]], f"{name}: roots differ")
        trace = ex.trace
        check(_trace_sha(trace) == g["trace_sha256"], f"{name}: trace differs")
        prover = Prover(ex.air(), device=dev)
        prover.coin_journal = []
        proof = prover.prove(trace)
        _golden_check(name, g, prover, proof)
        log(f"  {name}: {time.perf_counter() - t0:.1f} s with the witness")


# the path whose launches a row of the kernels line reports, where it is
# not the 128-transaction path of its hash: the merge kernels run one level
# at a time only in the PoW search since the tree kernels
ROW_PATHS = {"rescue_permutation": "chain1024",
             "blake3_merge": "grind_blake3_16",
             "sha256_merge": "grind_sha256_12", "sha3_merge": "grind_sha3_12"}
# the kernels each main path must launch: the transaction paths the trace,
# evaluation and composition kernels besides their hash's; the standalone
# AIRs their own evaluations and the composition kernel (the 128-unit ones
# the trace kernel too)
TAIL_KERNELS = ("ood", "deep", "fri_fold")
# every path launches ood and deep; fri_fold once a FRI layer, and a
# domain at or below the FRI remainder (merkle-init's) has none:
# _check_tail counts them exactly
TAIL_NEED = ("ood", "deep")
TX_KERNELS = ("f63_mul", "blake3_leaves", "blake3_tree", "transaction_trace",
              "transaction_eval", "compose", "ntt", "lde") + TAIL_NEED
SHA3_KERNELS = ("f63_mul", "sha3_leaves", "sha3_tree", "transaction_trace",
                "transaction_eval", "compose", "ntt", "lde") + TAIL_NEED
SHA256_KERNELS = ("f63_mul", "sha256_leaves", "sha256_tree",
                  "transaction_trace", "transaction_eval", "compose", "ntt",
                  "lde") + TAIL_NEED
SUBAIR_KERNELS = ("f63_mul", "blake3_leaves", "blake3_tree", "compose", "ntt",
                  "lde") + TAIL_NEED


def phase_checkpoint(dev):
    """Checkpoint and resume on the card, for each of CHECKPOINT_GOLDENS:
    a proof with a checkpoint directory (from tempfile, outside the
    repository) equals the golden; a fresh Prover fed a zero trace resumes
    every phase from the directory and gives the same bytes. Prints the
    directory's bytes, the times of a proof without a checkpoint, with one
    saved, and resumed (trace built beforehand), then deletes it."""
    import shutil
    import tempfile
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.utils import curve as CV
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        goldens = json.load(f)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = fn().to_bytes()
        torch.cuda.synchronize()
        return raw, (time.perf_counter() - t0) * 1e3

    for name in CHECKPOINT_GOLDENS:
        g = goldens[name]
        opts = ProofOptions(**g["options"])
        if "curve" in g:
            CV.set_curve(g["curve"])
            ex = TX.TransactionExample(g["num_transactions"], opts,
                                       depth=g["depth"], seed=g["seed"],
                                       device=dev)
        else:
            ex = RC.RescueChainExample(g["chain_length"], opts, device=dev)
        trace = ex.trace
        prover = Prover(ex.air(), device=dev)
        raw, plain_ms = timed(lambda: prover.prove(trace))
        directory = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
        try:
            raw_ck, save_ms = timed(lambda: prover.prove(
                trace, checkpoint=prover.checkpointer(directory)))
            files = os.listdir(directory)
            nbytes = sum(os.path.getsize(os.path.join(directory, f))
                         for f in files)
            fresh = Prover(ex.air(), device=dev)
            zero = torch.zeros_like(trace)
            raw_resumed, resume_ms = timed(lambda: fresh.prove(
                zero, checkpoint=fresh.checkpointer(directory)))
        finally:
            shutil.rmtree(directory)
        sha = hashlib.sha256(raw).hexdigest()
        check(sha == g["proof_sha256"], f"{name}: proof differs from golden")
        check(raw_ck == raw, f"{name}: the checkpointed proof differs")
        check(raw_resumed == raw, f"{name}: the resumed proof differs")
        log(f"checkpoint {name}: {nbytes} B in {len(files)} files; prove "
            f"{plain_ms:.1f} ms, with the checkpoint "
            f"saved {save_ms:.1f} ms, resumed from it with a zero trace "
            f"{resume_ms:.1f} ms; all three equal the golden {sha[:16]}...")


def _timed_proof(dev, ex, what, need, trace=None, again=True):
    """ex.options' proof of ex's statement: warm-up (on `trace` where
    given, else on a trace built for it), then the counted and timed
    main-path run, the trace build (`ex.trace`) included, on a Prover
    built before the timed window; then, with `again`, one `ex.prove()`,
    timed as bench.py and benches.py time it (a new Prover each call, its
    set-up included). Checks that every kernel in `need` was launched;
    returns (prover, proof bytes, launches)."""
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    prover = Prover(ex.air(), device=dev)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    warm = prover.prove(ex.trace if trace is None else trace).to_bytes()

    spans = []
    t_last = [0.0]

    def mark(label):
        # the span's time and the peak device memory within it
        torch.cuda.synchronize()
        now = time.perf_counter()
        spans.append((label, (now - t_last[0]) * 1e3,
                      torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        t_last[0] = now

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = t_last[0] = time.perf_counter()
    trace = ex.trace
    mark("trace build (pack + kernel)")
    proof = prover.prove(trace, mark=mark)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in K.WRAPPERS}
    peak = max(p for _, _, p in spans)
    raw = proof.to_bytes()
    log(f"{what}: prove wall (trace build included) {wall * 1e3:.1f} ms; "
        f"prover set-up {setup_ms:.1f} ms")
    for label, ms, pk in spans:
        log(f"  {label:32s} {ms:10.1f} ms  peak {pk / 2**20:8.0f} MiB")
    log(f"  peak device memory {peak / 2**20:.0f} MiB; domain {prover.bn} "
        f"points in segments of {prover.chunk}; kernel launches {launches}")
    for name in need:
        check(launches[name] > 0, f"{name} was not launched on the main "
              f"path ({what})")
    # one evaluation (the transaction AIR's) and one composition a segment
    segments = prover.bn // prover.chunk
    check(launches["compose"] == segments,
          f"{what}: {launches['compose']} compose launches, {segments} "
          "segments")
    check(launches["transaction_eval"] in (0, segments) and
          (launches["transaction_eval"] > 0) ==
          (prover.eval_consts is not None),
          f"{what}: {launches['transaction_eval']} transaction_eval "
          f"launches, {segments} segments")
    for hash_fn in ("blake3", "sha256", "sha3"):
        check(launches[f"{hash_fn}_tree"] == launches[f"{hash_fn}_leaves"],
              f"{what}: not one {hash_fn}_tree launch a commitment")
    _check_tail(launches, segments, len(proof.fri_roots), what)
    check(raw == warm, "two proofs of the same statement differ")
    if again:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw_again = ex.prove().to_bytes()
        torch.cuda.synchronize()
        log(f"  ex.prove() wall (set-up and trace build included, as "
            f"bench.py times it) {(time.perf_counter() - t0) * 1e3:.1f} ms")
        check(raw_again == raw, "ex.prove() differs from the main-path proof")
    log(f"  proof {len(raw)} B, sha256 {hashlib.sha256(raw).hexdigest()}, "
        f"security {proof.security_level()} bits")
    return prover, raw, launches


def _check_tail(launches, segments, layers, what):
    """One ood launch a proof, one deep launch a domain segment and one
    fri_fold launch a FRI layer."""
    check((launches["ood"], launches["deep"], launches["fri_fold"]) ==
          (1, segments, layers),
          f"{what}: ood, deep, fri_fold launched {launches['ood']}, "
          f"{launches['deep']}, {launches['fri_fold']} times; expected 1, "
          f"{segments} (segments), {layers} (FRI layers)")


def phase_tx_full(dev, ex, what="bench options"):
    """The composed AIR at 128 transactions, depth 15, with ex.options
    (bench.py's, or the example CLI's cubic ones)."""
    return _timed_proof(dev, ex, f"{TX_COUNT} tx depth {TX_DEPTH}, {what}",
                        TX_KERNELS)


def phase_verify(ex, raw, what):
    """The port's verifier (host Python ints) accepts the proof `raw` of
    `ex`'s statement, timed; where the time goes, from one more run under
    cProfile; and it rejects a copy with one query value flipped and one
    with one OOD value flipped."""
    import cProfile
    import pstats
    from certificate_stark_tpu_torch.engine.proof import Proof
    from certificate_stark_tpu_torch.engine.verifier import VerificationError
    from certificate_stark_tpu_torch.ops.field import P
    t0 = time.perf_counter()
    check(ex.verify(Proof.from_bytes(raw)) is True,
          f"{what}: the port's verifier rejects the proof")
    ms = (time.perf_counter() - t0) * 1e3
    prof = cProfile.Profile()
    prof.runcall(ex.verify, Proof.from_bytes(raw))
    stats = pstats.Stats(prof).stats
    parts = {name: max((v[3] for (_, _, fn), v in stats.items()
                        if fn == name), default=0.0) * 1e3
             for name in ("_periodic_values_at", "evaluate_transition",
                          "verify_path")}
    log(f"{what}: the port's verifier accepts it in {ms:.1f} ms; under "
        "cProfile (cumulative ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in parts.items()))
    for field, flip in (("query value", lambda p: p.queries[0].trace_row),
                        ("OOD value", lambda p: p.ood_trace_z)):
        bad = Proof.from_bytes(raw)
        vals = flip(bad)
        vals[1] = (vals[1] + 1) % P
        try:
            ex.verify(bad)
        except VerificationError as e:
            log(f"  a flipped {field}: rejected ({str(e)[:40]})")
        else:
            check(False, f"{what}: a proof with a flipped {field} passes")
    return ms


def _device_by_name(prof):
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    return by_name


def profile_tx_proof(ex, prover, what):
    """One warm proof (trace build included) under torch.profiler: device
    time by kernel, busy share of the wall time. `what` names the path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.prove(ex.trace)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = _device_by_name(prof)
    device_ms = sum(t for t, _ in by_name.values())
    log(f"profile, {what} warm proof (trace build "
        f"included): wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
        f"({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(c for _, c in by_name.values())} kernel launches")
    groups = {}
    for name, (t, c) in by_name.items():
        key = next((k for k in ("f63_mul", "blake3_leaves", "blake3_merge",
                                "blake3_tree", "sha256_leaves",
                                "sha256_merge", "sha256_tree",
                                "sha3_leaves", "sha3_merge",
                                "sha3_tree",
                                "transaction_trace", "transaction_eval",
                                "compose", "rescue_perm",
                                "ntt_pass_kernel<false",
                                "ntt_pass_kernel<true", "ood_kernel",
                                "ood_pow_kernel", "ood_total_kernel",
                                "deep_kernel",
                                "fri_fold_kernel")
                    if k in name), "PyTorch ops")
        key = {"ntt_pass_kernel<false": "ntt",
               "ntt_pass_kernel<true": "lde", "ood_kernel": "ood",
               "ood_pow_kernel": "ood", "ood_total_kernel": "ood",
               "deep_kernel": "deep",
               "fri_fold_kernel": "fri_fold"}.get(key, key)
        gt, gc = groups.get(key, (0.0, 0))
        groups[key] = (gt + t, gc + c)
    for key, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {t:9.3f} ms {c:6d}x {key}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {t:9.3f} ms {c:6d}x {name[:90]}")


def phase_tx_profile(dev, ex, prover):
    """The warm proof's profile (profile_tx_proof), the trace build alone,
    then the first segment's constraint evaluation and composition alone,
    through the kernels and through the PyTorch route they replaced: wall,
    device time (CUDA events) and launches. Returns the trace LDE."""
    from torch.profiler import ProfilerActivity, profile
    from certificate_stark_tpu_torch.ops import kernels as K
    profile_tx_proof(ex, prover, f"{TX_COUNT} tx, bench options")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace = ex.trace
        torch.cuda.synchronize()
    log("profile, trace build alone: " + ", ".join(
        f"{name[:40]} {t:.3f} ms {c}x"
        for name, (t, c) in _device_by_name(prof).items()))

    lde = prover.phase_trace(trace)[1]
    coeffs = _random_coeffs(prover, 1)
    for what, route in (
            ("the kernels (transaction_eval, compose)",
             lambda: prover._compose(lde, 0, prover.chunk, *coeffs)),
            ("the PyTorch route they replace (the plain versions' ops "
             "around f63_mul)", lambda: _pytorch_route(prover, lde, coeffs))):
        route()
        torch.cuda.synchronize()
        K.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            route()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counts = {fn.__name__: fn.launches for fn in (
            K.transaction_eval, K.compose, K.f63_mul)}
        ev = _device_by_name(prof)
        log(f"constraint evaluation + composition of one {prover.chunk}-point "
            f"segment through {what}: wall {wall:.1f} ms, device "
            f"{cuda_ms(route, 3):.1f} ms (CUDA events); launches {counts}, "
            f"{sum(c for _, c in ev.values())} in the profile")
    return lde


def _random_coeffs(prover, seed, d=None):
    """Random composition coefficients for prover's AIR in the extension of
    degree d (the prover's by default): t_alpha, t_beta [d, C], b_alpha,
    b_beta [d, NB]."""
    from certificate_stark_tpu_torch.ops import field as F
    g = torch.Generator(device=prover.device).manual_seed(seed)
    C, NB = len(prover.degrees), len(prover.assertions)
    return [torch.randint(0, F.P, (d or prover.d, k), generator=g,
                          device=prover.device, dtype=torch.int64)
            for k in (C, C, NB, NB)]


def _pytorch_route(prover, lde, coeffs):
    """The evaluation and composition of the first segment as the prover
    ran them before the kernels: the plain versions' PyTorch ops, each
    field multiply an f63_mul launch."""
    from certificate_stark_tpu_torch.ops import kernels as K
    cur, nxt = prover._frame(lde, 0, prover.chunk)
    evals = K.transaction_eval_plain(cur, nxt, prover.periodic,
                                     prover.eval_consts)
    return K.compose_plain(evals, cur, 0, prover.comp_tabs, *coeffs)


def _eval_muls(form, differences=None):
    """32-bit multiplies a point that the transaction AIR's 115 constraint
    slots need, the multiply by b3 of `form` taking 6, 9 or 18 Montgomery
    multiplies: (Montgomery multiplies, squarings, 14-term MDS rows) in the
    units of MULS_PER_MMUL, MULS_PER_MSQR and MULS_PER_MDS_ROW. The nine
    flagged Rescue round ranges read five distinct register bases
    (ops/kernels.py EVAL_ROUNDS), so the function needs five round
    differences; `differences=9` counts one for each range, as a kernel
    that evaluates each range's round on its own does."""
    from certificate_stark_tpu_torch.ops import kernels as K
    ranges = sum(len(r) for _, r in K.EVAL_ROUNDS)
    differences = differences or len(K.EVAL_ROUNDS)
    b3 = {"subfield": 6, "fp2": 9, "full_fp6": 18}[form]
    # two doublings and two mixed additions (11 fp6 multiplies and 2 by b3
    # each), the full addition (12 and 2) and its x * Z check (1)
    ec = (4 * 11 + 12 + 1) * 18 + 10 * b3
    mmul = (ec
            + 2 * (18 * 4 + 2)   # the two points' equalities, bit checks
            + differences * 28   # the round differences' cubes
            + ranges * 14        # a flag a slot of each round range
            + 27 + 54            # setup values; key and value copies
            + 228                # Merkle authentication besides rounds
            + 85                 # Schnorr's final, limb, hash-row flags
            + 5)                 # range proofs
    msqr = 2 + differences * 28 + 2 + 2   # bit squares; the cubes
    rows = differences * 28               # two MDS layers a difference
    return mmul * MULS_PER_MMUL + msqr * MULS_PER_MSQR + \
        rows * MULS_PER_MDS_ROW


def _compose_cost(tabs, C, d, S, unreduced=True):
    """(bytes, 32-bit multiplies) of compose on S points: each input row
    read once (constraint values, the assertions' trace columns, x^adj,
    zerofier, divisors, varying boundary values), d rows written. The
    products as the kernel sums them: 2d a constraint and an assertion
    into unreduced sums, each sum reduced once; an adjustment group's beta
    sums reduced and times x^adj into the alpha sums (d each); a boundary
    group's the same, then its sums reduced and times the divisor; the
    zerofier's d. With unreduced=False every product a Montgomery
    multiply: 2d a constraint and an assertion, d an adjustment group's
    x^adj, 2d a boundary group's, d the zerofier."""
    rows = C + len(set(tabs.b_col)) + tabs.xpow.shape[0] + 1 + \
        tabs.b_invz.shape[0] + tabs.b_ev.shape[0] + d
    At, NA, G = len(tabs.t_row), len(tabs.b_col), len(tabs.b_adj)
    if unreduced:
        muls = d * (2 * (C + NA) * MULS_PER_MAC
                    + At * (MULS_PER_REDC + MULS_PER_MAC)
                    + MULS_PER_REDC + MULS_PER_MMUL
                    + G * (2 * MULS_PER_REDC + MULS_PER_MAC + MULS_PER_MMUL))
    else:
        muls = d * (2 * C + At + 1 + 2 * NA + 2 * G) * MULS_PER_MMUL
    return rows * 8 * S, muls * S


def _compose_worst(dev, S):
    """compose's worst case for its unreduced sums, on S points: every
    evaluation, coefficient, trace and table value p - 1 and every
    boundary value 0 (each product (p - 1)^2), the transaction AIR's 115
    constraints in one adjustment group and 16 assertions in one boundary
    group -> (evals, cur, tables, the coefficients of degree d of d)."""
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.ops import kernels as K
    C, NA, w = K.TX_SLOTS, 16, 4

    def full(*shape):
        return torch.full(shape, F.P - 1, dtype=torch.int64, device=dev)
    tabs = K.compose_tables(
        full(2, S), full(S), full(1, S),
        torch.empty((0, S), dtype=torch.int64, device=dev),
        [(0, list(range(C)))], [(1, [(a % w, a, -1, 0) for a in range(NA)])])
    return full(C, S), full(w, S), tabs, \
        lambda d: [full(d, n) for n in (C, C, NA, NA)]


def _plain_timed(fn):
    """fn() inside plain_versions(), and its wall ms (the device
    synchronized before and after)."""
    from certificate_stark_tpu_torch.ops import kernels as K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with K.plain_versions():
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_eval(dev, prover, lde):
    """transaction_eval and compose on the first 2^20-point segment of the
    128-transaction proof (`prover`'s tables, the trace LDE `lde`), each
    bit for bit against its plain version (inside plain_versions()):
    transaction_eval with every b3 form of _b3_forms(), compose at d = 1,
    2 and 3 on its output with random coefficients, and on _compose_worst.
    Both timed (CUDA events), beside their bounds and the plain versions'
    times, with their registers and spills from the ptxas report and
    their launch shapes (dynamic shared memory, resident blocks an SM;
    transaction_eval's tile and warps, compose's persistent grid). Returns
    the two rows of the kernels line."""
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.ops import kernels as K
    S = prover.chunk
    cur, nxt = prover._frame(lde, 0, S)
    per = prover.periodic
    err, ms_by_form, plain_by_form, bound_by_form = 0, {}, {}, {}
    main_b3 = F.to_ints(prover.eval_consts["b3"]).tolist()
    for form, b3 in _b3_forms().items():
        consts = dict(prover.eval_consts, b3=F.from_ints(b3, dev))
        got = K.transaction_eval(cur, nxt, per, consts)
        exp, plain_by_form[form] = _plain_timed(
            lambda: K.transaction_eval(cur, nxt, per, consts))
        e = int((got - exp).abs().max())
        if e:
            bad = (got != exp).any(dim=1).nonzero().flatten().tolist()
            log(f"  transaction_eval, b3 {form}: slots {bad} differ")
        err = max(err, e)
        check(e == 0, f"transaction_eval differs from its plain version "
              f"(b3 {form})")
        del got, exp
        ms_by_form[form] = cuda_ms(
            lambda: K.transaction_eval(cur, nxt, per, consts), 10)
        nbytes = (2 * K.TX_WIDTH + K.TX_PERIODIC + K.TX_SLOTS) * 8 * S
        bound_by_form[form] = bound_ms(nbytes, _eval_muls(form) * S)
        old = bound_ms(nbytes, _eval_muls(form, 9) * S)[0]
        log(f"transaction_eval == plain ([{K.TX_SLOTS}, {S}], b3 {form}): "
            f"{ms_by_form[form]:.4f} ms, plain {plain_by_form[form]:.1f} ms, "
            f"bound {bound_by_form[form][0]:.4f} ms "
            f"({bound_by_form[form][1]}, {_eval_muls(form)} 32-bit "
            f"multiplies a point for {len(K.EVAL_ROUNDS)} round "
            f"differences; {_eval_muls(form, 9)} and {old:.4f} ms counting "
            f"one a flagged range, 9)")
    main = next(f for f, b3 in _b3_forms().items() if b3 == main_b3)
    use = _ptxas_usage("air_eval", "transaction_eval")
    use.update(K.transaction_eval_occupancy())
    log(f"transaction_eval registers, stack and spills a thread, launch "
        f"shape: {use}")
    rows = [dict(name="transaction_eval", route="cuda",
                 source="certificate_stark_tpu_torch/csrc/air_eval.cu",
                 replaces="certificate_stark_tpu/models/transaction.py:237",
                 max_abs_err=err, ms=ms_by_form[main],
                 plain_ms=plain_by_form[main],
                 bound_ms=bound_by_form[main][0],
                 bound_by=bound_by_form[main][1], library_ms=None,
                 shape=[K.TX_SLOTS, S], b3=main, ms_by_b3=ms_by_form,
                 plain_ms_by_b3=plain_by_form,
                 bound_ms_by_b3={f: b[0] for f, b in bound_by_form.items()},
                 **use)]

    evals = K.transaction_eval(cur, nxt, per, prover.eval_consts)
    tabs, C = prover.comp_tabs, evals.shape[0]
    w_evals, w_cur, w_tabs, w_coeffs = _compose_worst(dev, 1 << 16)
    err, by_d = 0, {}
    for d in (1, 2, 3):
        coeffs = _random_coeffs(prover, 10 + d, d)
        got = K.compose(evals, cur, 0, tabs, *coeffs)
        exp, plain = _plain_timed(
            lambda: K.compose(evals, cur, 0, tabs, *coeffs))
        err = max(err, int((got - exp).abs().max()))
        check(err == 0, f"compose differs from its plain version (d = {d})")
        wc = w_coeffs(d)
        got = K.compose(w_evals, w_cur, 0, w_tabs, *wc)
        exp = _plain_timed(lambda: K.compose(w_evals, w_cur, 0, w_tabs,
                                             *wc))[0]
        err = max(err, int((got - exp).abs().max()))
        check(err == 0, f"compose differs from its plain version on the "
              f"all-(p - 1) input (d = {d})")
        del got, exp
        ms = cuda_ms(lambda: K.compose(evals, cur, 0, tabs, *coeffs), 10)
        nbytes, muls = _compose_cost(tabs, C, d, S)
        old_muls = _compose_cost(tabs, C, d, S, unreduced=False)[1]
        bnd, by = bound_ms(nbytes, muls)
        t_bytes = bound_ms(nbytes, 0)[0]
        use = _ptxas_usage("compose", f"compose_kernelILi{d}ELb1E")
        use.update(K.compose_occupancy(tabs, d, S))
        scalar = _ptxas_usage("compose", f"compose_kernelILi{d}ELb0E")
        by_d[d] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                       **use)
        log(f"compose == plain ([{d}, {S}] from [{C}, {S}] evaluations, "
            f"{len(tabs.t_row)} adjustment groups, {len(tabs.b_col)} "
            f"assertions in {len(tabs.b_adj)} groups; and on the all-(p - 1) "
            f"input, [{d}, {w_evals.shape[1]}]): {ms:.4f} ms, plain "
            f"{plain:.1f} ms, bound {bnd:.4f} ms ({by}; bytes {t_bytes:.4f}; "
            f"{muls // S} 32-bit multiplies a point summed unreduced, "
            f"{old_muls // S} and {bound_ms(0, old_muls)[0]:.4f} ms as "
            f"Montgomery multiplies); {use}; without 16-byte loads "
            f"{scalar}")
    main = 3     # the cubic path's degree, whose launches the row counts
    rows.append(dict(name="compose", route="cuda",
                     source="certificate_stark_tpu_torch/csrc/compose.cu",
                     replaces="certificate_stark_tpu/engine/prover.py:628",
                     max_abs_err=err, library_ms=None, shape=[main, S],
                     by_degree=by_d, **{k: by_d[main][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by")}))
    return rows


def _plain_equal(dev, ex, kernel_raw, what, trace=None):
    """ex's proof with the plain versions, the plain trace build included
    (or on `trace`, a trace built by the plain version before, kept on the
    host so that it adds to no path's peak device memory): the same bytes
    as with the kernels. Returns the trace it proved, on the host."""
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.ops import kernels as K
    built = trace is None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with K.plain_versions():
        prover = Prover(ex.air(), device=dev)
        trace = ex.trace if built else trace.to(dev)
        raw = prover.prove(trace).to_bytes()
    torch.cuda.synchronize()
    log(f"{what}: prove with plain versions ("
        + ("trace build and prover set-up included" if built else
           "prover set-up included, on the plain trace built before")
        + f"): {(time.perf_counter() - t0) * 1e3:.1f} ms")
    check(raw == kernel_raw, f"{what}: the proof with kernels differs from "
          "the plain one")
    log(f"{what}: proofs with kernels and with plain versions are equal, "
        f"sha256 {hashlib.sha256(raw).hexdigest()[:16]}...")
    return trace.cpu()


def phase_tx_plain(dev, ex, kernel_raw, what="bench options", trace=None):
    """The 128-transaction proof with the plain versions; the cubic paths
    on the same witness reuse the base path's plain trace (`trace`), which
    that proof's bytes, and phase_trace_kernel, hold equal to the trace
    kernel's. Returns the plain trace."""
    return _plain_equal(dev, ex, kernel_raw, f"{TX_COUNT} tx, {what}", trace)


def phase_sha_paths(dev, ex, plain_trace):
    """The two SHA main paths on ex's 128-transaction witness: the example
    CLI's cubic defaults with --hash-fn sha3, and bench.py's options with
    hash_fn sha256. Each: the timed main-path run with its launches, a
    profile, the port's verifier (tampered copies rejected). The sha3 proof
    is proven again with the plain versions (on `plain_trace`, the plain
    trace of ex's witness); the sha256 proof equals the
    pinned TX128_SHA256_PATH, and its path's plain versions run at 16
    transactions (seed 42), on a proof made with the kernels there.
    Returns the launch counts of both paths."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import transaction as TX
    launches = {}
    for key, od, need, what in (
            ("tx128_sha3_cubic", dict(CLI_OPTS, hash_fn="sha3"), SHA3_KERNELS,
             "cubic, SHA3-256 (the example CLI's defaults, --hash-fn sha3)"),
            ("tx128_sha256", dict(BENCH_OPTS, hash_fn="sha256"),
             SHA256_KERNELS, "bench options, SHA-256")):
        path = copy.copy(ex)
        path.options = ProofOptions(**od)
        prover, raw, launches[key] = _timed_proof(
            dev, path, f"{TX_COUNT} tx depth {TX_DEPTH}, {what}", need)
        profile_tx_proof(path, prover, f"{TX_COUNT} tx, {what}")
        del prover
        phase_verify(path, raw, f"{TX_COUNT} tx, {what}")
        if key == "tx128_sha3_cubic":
            phase_tx_plain(dev, path, raw, what, plain_trace)
            continue
        sha = hashlib.sha256(raw).hexdigest()
        check((sha, len(raw)) == TX128_SHA256_PATH,
              f"{TX_COUNT} tx, {what}: proof {sha} ({len(raw)} B) differs "
              f"from the pinned {TX128_SHA256_PATH}")
        small = TX.TransactionExample(16, path.options, depth=TX_DEPTH,
                                      seed=42, device=dev)
        small_raw = Prover(small.air(), device=dev).prove(
            small.trace).to_bytes()
        _plain_equal(dev, small, small_raw, f"16 tx depth {TX_DEPTH}, {what}")
    return launches


def _subair_example(name, golden, opts, dev):
    """The port's example of one standalone-AIR golden's statement."""
    from certificate_stark_tpu_torch.models import merkle_init as MI
    from certificate_stark_tpu_torch.models import merkle_update as MU
    from certificate_stark_tpu_torch.models import range as RG
    from certificate_stark_tpu_torch.models import schnorr as SC
    if name.startswith("range"):
        return RG.RangeExample(golden.get("number", 0x0123456789ABCDEF), opts,
                               device=dev)
    if name.startswith("merkle_init"):
        return MI.MerkleInitExample(opts, device=dev)
    if name.startswith("merkle_update"):
        return MU.MerkleUpdateExample(golden["num_transactions"], opts,
                                      depth=golden["depth"],
                                      seed=golden["seed"], device=dev)
    return SC.SchnorrExample(golden["num_signatures"], opts,
                             seed=golden["seed"], device=dev)


def phase_subair_goldens(dev):
    """The standalone AIRs' goldens reproduced on the card: trace (where
    the golden records it), public roots, coin journal and proof bytes."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.utils import curve as CV
    CV.set_curve("fp2")
    for name, (path, od) in SUBAIR_GOLDENS.items():
        with open(os.path.join(ROOT, "tests", "vectors", path)) as f:
            g = json.load(f)[name]
        t0 = time.perf_counter()
        ex = _subair_example(name, g, ProofOptions(**(od or g["options"])),
                             dev)
        if "initial_root" in g:
            check([list(r) for r in ex.pub_inputs()] ==
                  [g["initial_root"], g["final_root"]], f"{name}: roots differ")
        trace = ex.trace
        if "trace_sha256" in g:
            check(_trace_sha(trace) == g["trace_sha256"],
                  f"{name}: trace differs")
        prover = Prover(ex.air(), device=dev)
        prover.coin_journal = []
        _golden_check(name, g, prover, prover.prove(trace))
        log(f"  {name}: {time.perf_counter() - t0:.1f} s with the witness")


def phase_verify_pub(ex, raw, what):
    """The port's verifier accepts the proof `raw` of ex's statement,
    timed, and rejects it against a wrong public input: the number negated,
    delta doubled, a final-root element or a message element changed."""
    from certificate_stark_tpu_torch.engine.proof import Proof
    from certificate_stark_tpu_torch.engine.verifier import VerificationError
    from certificate_stark_tpu_torch.ops.field import P
    t0 = time.perf_counter()
    check(ex.verify(Proof.from_bytes(raw)) is True,
          f"{what}: the port's verifier rejects the proof")
    log(f"{what}: the port's verifier accepts it in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if hasattr(ex, "number"):
        wrong = dict(number=(-ex.number) % P)
    elif hasattr(ex, "delta"):
        wrong = dict(pub_inputs=(ex.s_inputs, ex.r_inputs, 2 * ex.delta))
    elif hasattr(ex, "md"):
        initial, final = ex.pub_inputs()
        wrong = dict(pub_inputs=(initial, [(final[0] + 1) % P] + final[1:]))
    else:
        messages = [list(m) for m in ex.messages]
        messages[0][13] = (messages[0][13] + 1) % P
        wrong = dict(pub_inputs=(messages, ex.signatures))
    try:
        ex.verify(Proof.from_bytes(raw), **wrong)
    except VerificationError as e:
        log(f"  {what}, a wrong public input: rejected ({str(e)[:40]})")
    else:
        check(False, f"{what}: a wrong public input passes")


def phase_subairs(dev):
    """The reference's other benchmark groups at its sizes and bench.py's
    options (benches.py --full): range 64-bit, merkle-init, merkle-update
    at 128 transactions depth 15, Schnorr at 128 signatures. Each: the
    witness time, the main-path run (_timed_proof), the port's verifier
    (timed; a wrong public input rejected); the two 128-unit paths are also
    profiled, the trace kernel timed on their inputs, and proven with the
    plain versions (equal bytes). Returns the launch counts and the trace
    kernel's times of the two 128-unit paths."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.models import merkle_init as MI
    from certificate_stark_tpu_torch.models import merkle_update as MU
    from certificate_stark_tpu_torch.models import range as RG
    from certificate_stark_tpu_torch.models import schnorr as SC
    from certificate_stark_tpu_torch.utils import curve as CV
    CV.set_curve("fp2")
    opts = ProofOptions(**BENCH_OPTS)
    number = 123456789123456789
    paths = (
        ("range 64-bit", lambda: RG.RangeExample(number, opts, device=dev),
         None),
        ("merkle-init", lambda: MI.MerkleInitExample(opts, device=dev), None),
        (f"merkle-update {SUBAIR_UNITS} tx depth {TX_DEPTH}",
         lambda: MU.MerkleUpdateExample(SUBAIR_UNITS, opts, depth=TX_DEPTH,
                                        seed=1, device=dev),
         "merkle_update128"),
        (f"Schnorr {SUBAIR_UNITS} signatures",
         lambda: SC.SchnorrExample(SUBAIR_UNITS, opts, seed=5, device=dev),
         "schnorr128"))
    launches, trace_ms = {}, {}
    for what, make, key in paths:
        t0 = time.perf_counter()
        ex = make()
        log(f"witness, {what} (host Python): "
            f"{time.perf_counter() - t0:.1f} s")
        need = SUBAIR_KERNELS + (("transaction_trace",) if key else ())
        prover, raw, counts = _timed_proof(dev, ex, what, need)
        if key:
            launches[key] = counts
            trace_ms[key] = _subtrace_kernel_ms(ex, what)
            profile_tx_proof(ex, prover, what)
        phase_verify_pub(ex, raw, what)
        if key:
            _plain_equal(dev, ex, raw, what)
    return launches, trace_ms


def _subtrace_kernel_ms(ex, what):
    """The trace kernel alone on a 128-unit path's packed inputs, timed
    (CUDA events; the host packing and the cut are not included)."""
    from certificate_stark_tpu_torch.models import trace_device as TD
    from certificate_stark_tpu_torch.ops import kernels as K
    if hasattr(ex, "md"):
        depth = ex.depth
        inputs, consts = TD.pack_mu(ex.md.tx_dicts(), depth, ex.device)
    else:
        depth = 1
        inputs, consts = TD.pack_sig(ex.messages, ex.signatures, ex.device)
    ms = cuda_ms(lambda: K.transaction_trace(inputs, consts, depth), 20)
    log(f"{what}: transaction_trace on its inputs (depth {depth}): "
        f"{ms:.4f} ms")
    return ms


def _tx1024_witness(conn):
    """The 1024-transaction depth-15 witness (host Python; seed 42, the fp2
    curve, as the 128-transaction one), built in a worker process and sent
    back with its seconds. The example's device is the CPU until the main
    process sets it."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.utils import curve as CV
    CV.set_curve("fp2")
    t0 = time.perf_counter()
    ex = TX.TransactionExample(TX1024, ProofOptions(**BENCH_OPTS),
                               depth=TX_DEPTH, device="cpu")
    conn.send((ex, time.perf_counter() - t0))
    conn.close()


def start_witness():
    """Starts _tx1024_witness in a spawn worker, so that its minutes of
    host Python overlap the phases before the 1024-transaction one:
    (process, receiving end)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_tx1024_witness, args=(send,), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def phase_trace1024(dev, ex, latency_ns):
    """The trace kernel at 1024 transactions on ex's witness, timed with
    its host packing, and held against its plain version on the row blocks
    of the transactions TX1024_BLOCKS (the plain trace of their packed
    inputs alone: a transaction's rows depend only on its own inputs).
    Returns the trace, for the proofs' warm-ups."""
    from certificate_stark_tpu_torch.models import trace_device as TD
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.utils import curve as CV
    depth = ex.depth
    t0 = time.perf_counter()
    inputs, consts = TD.pack_witness(ex.md, ex.messages, dev)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    trace = K.transaction_trace(inputs, consts, depth)
    ms = cuda_ms(lambda: K.transaction_trace(inputs, consts, depth), 5)
    idx = list(TX1024_BLOCKS)
    t0 = time.perf_counter()
    with K.plain_versions():
        exp = TD.build_trace_plain(TD.select_transactions(inputs, idx),
                                   consts, depth)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = trace.view(94, TX1024, 1024)[:, idx].reshape(94, -1)
    bad = (got != exp).reshape(94, len(idx), 1024).nonzero()
    if bad.shape[0]:
        log(f"  {bad.shape[0]} cells differ; first (col, block, row): "
            f"{bad[:8].tolist()}")
    check(bad.shape[0] == 0, f"transaction_trace at {TX1024} tx differs "
          f"from its plain version on the blocks of transactions {idx}")
    nbytes = sum(t.numel() * 8 for t in inputs.values()) + trace.numel() * 8
    muls = _trace_muls(inputs, depth, CV.B3_LIMBS)
    bnd, by = bound_ms(nbytes, muls)
    chain, lane = _trace_chain(inputs, depth)
    log(f"transaction_trace [94, {trace.shape[1]}] ({TX1024} tx depth "
        f"{depth}): {ms:.4f} ms, bound {bnd:.4f} ms ({by}), critical-path "
        f"bound {chain * latency_ns * 1e-6:.4f} ms ({chain} dependent "
        f"multiplies, {lane} lane); host packing {pack_ms:.1f} ms; equal "
        f"to the plain version on transactions {idx} (plain {plain_ms:.1f} "
        f"ms for those {len(idx)})")
    return trace


def phase_tx1024(dev, witness, latency_ns):
    """The JAX package's north star, the composed AIR at 1024 transactions,
    depth 15 (trace 94 x 2^20, LDE 2^23, in segments of 2^20 points), on the
    witness of the worker `witness` (start_witness): the trace kernel at
    that size (phase_trace1024), then two main paths on the one witness,
    bench.py's options (`tx1024`) and the example CLI's cubic defaults
    (`tx1024_cubic`), each timed by phase after a warm-up (_timed_proof;
    no `ex.prove()` at this size), verified by the port's verifier (two
    tampered copies rejected); the base one profiled, and its trace LDE
    phase timed through the kernels and the plain versions (_lde_peaks).
    Both equal the pinned proofs of TX1024_VECTOR. The base proof's bytes go to build/tx1024_base.proof.
    Returns the launch counts of both paths."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    vectors = os.path.join(ROOT, "tests", "vectors")
    with open(os.path.join(vectors, TX1024_VECTOR)) as f:
        pin = json.load(f)
    with open(os.path.join(vectors, pin["proof_file"]), "rb") as f:
        pinned = f.read()
    proc, recv = witness
    t0 = time.perf_counter()
    ex, secs = recv.recv()
    proc.join()
    log(f"witness, {TX1024} tx depth {TX_DEPTH} (host Python, in a worker "
        f"started at the script's start): {secs:.1f} s; waited "
        f"{time.perf_counter() - t0:.1f} s for it here")
    ex.device = dev
    trace = phase_trace1024(dev, ex, latency_ns)
    launches = {}
    for key, od, what in (
            ("tx1024", BENCH_OPTS, "bench options"),
            ("tx1024_cubic", CLI_OPTS,
             "cubic, BLAKE3 (the example CLI's defaults)")):
        path = copy.copy(ex)
        path.options = ProofOptions(**od)
        prover, raw, launches[key] = _timed_proof(
            dev, path, f"{TX1024} tx depth {TX_DEPTH}, {what}", TX_KERNELS,
            trace=trace, again=False)
        if key == "tx1024":
            profile_tx_proof(path, prover, f"{TX1024} tx, {what}")
            _lde_peaks(prover, trace)
        del prover
        sha = hashlib.sha256(raw).hexdigest()
        if key == "tx1024":
            os.makedirs(OUT, exist_ok=True)
            with open(os.path.join(OUT, "tx1024_base.proof"), "wb") as f:
                f.write(raw)
            check(raw == pinned, f"{TX1024} tx, {what}: proof {sha} "
                  f"differs from the pinned {pin['proof_sha256']}")
        else:
            check((sha, len(raw)) == (pin["cubic_proof_sha256"],
                                      pin["cubic_proof_len"]),
                  f"{TX1024} tx, {what}: proof {sha} differs from the "
                  f"pinned {pin['cubic_proof_sha256']}")
        log(f"  equal to the pinned proof of {TX1024_VECTOR}")
        phase_verify(path, raw, f"{TX1024} tx, {what}")
    return launches


def _lde_peaks(prover, trace):
    """The trace LDE phase of `prover` (iNTT, then LDE) through the ntt and
    lde kernels and through their plain versions, the latter in the column
    groups the prover used before the lde kernel (at most chunk points of
    LDE a group): equal values; each route's time (host clock around
    synchronized work) and the peak device memory it adds to what is
    allocated before it."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.ops import ntt as NTT
    w, b, bn, off = trace.shape[0], prover.b, prover.bn, prover.offset
    g = max(1, w * prover.chunk // bn)

    def plain():
        with K.plain_versions():
            coeffs = NTT.intt(trace)
            out = torch.empty((w, bn), dtype=torch.int64, device=trace.device)
            for r0 in range(0, w, g):
                out[r0:r0 + g] = NTT.lde_from_coeffs(coeffs[r0:r0 + g], b, off)
        return out

    out = {}
    for label, fn in (
            ("through the kernels (ntt, lde)", lambda: prover.phase_trace(
                trace)[1]),
            (f"through the plain versions (column groups of {g} rows)",
             plain)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[label] = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        log(f"  trace LDE phase (iNTT, LDE) [{w}, {prover.n}] -> [{w}, {bn}] "
            f"{label}: {ms:.1f} ms, peak {peak:.0f} MiB above the "
            f"{base / 2**20:.0f} MiB allocated before it")
    check(torch.equal(*out.values()), "the trace LDE through the kernels "
          "differs from the plain versions'")


def _ntt_cost(C, n, blowup=1, inverse=False, lde=False):
    """Bytes (each input read once, each output written once) and 32-bit
    multiplies (MULS_PER_MMUL a Montgomery multiply: one a butterfly, one
    a point's coset factor in an LDE, one a point's 1/n, or n^-1 s^t, in
    an inverse) of the transform of C columns of n points, or of their LDE
    of `blowup` cosets."""
    L = n.bit_length() - 1
    mmuls = C * blowup * (n // 2 * L + (n if lde else 0)) \
        + (C * n if inverse else 0)
    return 8 * C * n * (1 + blowup), mmuls * MULS_PER_MMUL


def _ntt_traffic_ms(C, n, passes, blowup=1, lde=False):
    """The least time of the kernels' pass structure on the card's memory:
    each pass reads and writes the array once (the LDE's first reads the
    coefficients and writes blowup n points a column). A note beside the
    bound, which counts each input and output once."""
    width = blowup * n
    nbytes = 16 * C * width * passes if not lde else \
        8 * C * n * (1 + blowup) + 16 * C * width * (passes - 1)
    return nbytes / MEM_BYTES_PER_S * 1e3


def phase_ntt(dev, shapes=None):
    """The ntt and lde kernels (csrc/ntt.cu) bit for bit against their
    plain versions on the card (run on column slices of at most
    NTT_PLAIN_SLICE output points): single columns of 2^0 .. 2^23 (the
    LDE at blowup 8, or less where the output would pass 2^23; the inverse
    with and without the fused scale), blowups up to 2^19 on 1 .. 32
    points, the all-(p - 1) input, every shape in `shapes` (the wrappers'
    records of the paths run: {"ntt": {(C, n, inverse, scale)}, "lde":
    {(C, n, blowup, offset)}}) or, without it, NTT_MAIN and LDE_MAIN, the
    composition's fused inverse [d, 2^20] and [d, 2^23], and the
    1024-transaction trace LDE [94, 2^20] -> 2^23. Then each kernel timed
    (CUDA events) at NTT_TIMED / LDE_TIMED, whole and a pass at a time,
    beside its bound and the two-pass traffic floor, its passes (their
    rounds, blocks, shared memory), the plain version's time at the row's
    shape, and the ptxas report. Returns the two rows of the kernels
    line."""
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.ops import kernels as K
    rand = _randoms(dev)
    gen = F.GENERATOR
    o_inv = pow(gen, F.P - 2, F.P)
    err = {"ntt": 0, "lde": 0}
    count = {"ntt": 0, "lde": 0, "fused": 0}

    def held(name, got, plain_of, C, width, what):
        step = max(1, NTT_PLAIN_SLICE // width)
        e = 0
        with K.plain_versions():
            for c0 in range(0, C, step):
                exp = plain_of(slice(c0, c0 + step))
                e = max(e, int((got[c0:c0 + step] - exp).abs().max()))
                del exp
        err[name] = max(err[name], e)
        count[name] += 1
        check(e == 0, f"{name} differs from its plain version: {what}")

    def check_ntt(x, inverse, what, scale=None):
        scale = o_inv if scale == "1/o" else scale
        got = K.ntt(x, inverse, scale)
        count["fused"] += scale is not None
        held("ntt", got, lambda s: K.ntt(x[s], inverse, scale), x.shape[0],
             x.shape[1], f"{what}, [{x.shape[0]}, {x.shape[1]}], "
             f"inverse {inverse}, scale {scale}")

    def check_lde(x, b, o, what):
        got = K.lde(x, b, o)
        held("lde", got, lambda s: K.lde(x[s], b, o), x.shape[0],
             b * x.shape[1], f"{what}, [{x.shape[0]}, {x.shape[1]}], "
             f"blowup {b}, offset {o}")

    t0 = time.perf_counter()
    for L in range(NTT_CHECK_LOG + 1):
        x = rand(1, 1 << L)
        check_ntt(x, False, "a single column")
        check_ntt(x, True, "a single column")
        check_ntt(x, True, "a single column", "1/o")
        check_lde(x, min(8, 1 << (NTT_CHECK_LOG - L)), gen, "a single column")
    for L, lb in ((0, 12), (1, 12), (1, 19), (2, 16), (5, 12)):
        check_lde(rand(3, 1 << L), 1 << lb, 7, "a large blowup")
    full = torch.full(NTT_FULL, F.P - 1, dtype=torch.int64, device=dev)
    check_ntt(full, False, "all p - 1")
    check_ntt(full, True, "all p - 1")
    check_ntt(full, True, "all p - 1", "1/o")
    check_lde(full[:, :NTT_FULL[1] >> 3].contiguous(), 8, gen, "all p - 1")
    del full
    ntt_shapes = set(NTT_MAIN) if shapes is None else set(shapes["ntt"])
    ntt_shapes |= {(d, n, True, o_inv) for n in (1 << 20, 1 << 23)
                   for d in (1, 3)}
    lde_shapes = {(C, n, b, gen) for C, n, b in LDE_MAIN} \
        if shapes is None else set(shapes["lde"])
    lde_shapes.add(LDE_BIG + (gen,))
    for C, n, inverse, scale in sorted(ntt_shapes, key=str):
        check_ntt(rand(C, n), inverse, "a path's shape", scale)
    for C, n, b, o in sorted(lde_shapes):
        check_lde(rand(C, n), b, o, "a path's shape")
    torch.cuda.synchronize()
    log(f"ntt, lde == plain: {count['ntt']} and {count['lde']} checks "
        f"({len(ntt_shapes)} and {len(lde_shapes)} of them the paths' "
        f"shapes and the composition's fused inverse; {count['fused']} "
        f"with the fused scale), bit for bit; "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    rows = []
    for name, timed, row in (("ntt", NTT_TIMED, NTT_ROW),
                             ("lde", LDE_TIMED, LDE_ROW)):
        # the instantiations: ntt <false, 2>; lde <true, 3> for its first
        # pass, <true, 2> for the later ones (csrc/ntt.cu MINB)
        kern = {"ntt": ("ILb0ELi2E", "ILb0ELi2E"),
                "lde": ("ILb1ELi3E", "ILb1ELi2E")}[name]
        uses = [_ptxas_usage("ntt", "ntt_pass_kernel" + k) for k in kern]
        use = uses[0]
        log(f"{name}: ptxas {use}" + (f"; later passes {uses[1]}"
                                       if kern[1] != kern[0] else ""))
        by_shape = []
        for shape in timed:
            C, n, arg = shape[:3]
            x = rand(C, n)
            if name == "ntt":
                scale = o_inv if shape[3] == "1/o" else shape[3]
                fn = lambda: K.ntt(x, arg, scale)               # noqa: E731
                nbytes, muls = _ntt_cost(C, n, inverse=arg)
                plan = K.ntt_plan(n)
                out = torch.empty_like(x)
                launches = K.ntt_passes(x, out, arg, scale)
                floor = _ntt_traffic_ms(C, n, len(plan))
            else:
                fn = lambda: K.lde(x, arg, gen)                 # noqa: E731
                nbytes, muls = _ntt_cost(C, n, arg, lde=True)
                plan = K.ntt_plan(n, arg, lde=True)
                out = torch.empty((C, arg * n), dtype=torch.int64,
                                  device=dev)
                launches = K.lde_passes(x, out, arg, gen)
                floor = _ntt_traffic_ms(C, n, len(plan), arg, lde=True)
            ms = cuda_ms(fn, 5)
            pass_ms = [cuda_ms(fp, 5) for fp in launches]
            bnd, by = bound_ms(nbytes, muls)
            entry = dict(shape=[C, n], ms=ms, bound_ms=bnd, bound_by=by,
                         traffic_floor_ms=floor,
                         passes=[dict(log=ps["log"], rounds=ps["rounds"],
                                      log_R=ps["log_R"], log_G=ps["log_G"],
                                      blocks=ps["blocks"] * C,
                                      smem_bytes=ps["smem_bytes"], ms=pm,
                                      registers=uses[min(p, 1)].get(
                                          "registers"))
                                 for p, (ps, pm) in enumerate(
                                     zip(plan, pass_ms))],
                         **({"inverse": arg, "scale": shape[3]}
                            if name == "ntt" else {"blowup": arg}))
            if shape == row:
                torch.cuda.empty_cache()
                entry["plain_ms"] = _plain_timed(fn)[1]
            by_shape.append(entry)
            log(f"{name} [{C}, {n}] "
                + (f"inverse {arg} scale {shape[3]}" if name == "ntt"
                   else f"blowup {arg}")
                + f": {ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
                f"{100 * bnd / ms:.1f}%), two-pass traffic floor "
                f"{floor:.4f} ms (a note); passes (log2 n_p, rounds, log2 R, "
                f"log2 G, blocks, smem B, registers, ms) "
                + "; ".join(f"({p['log']}, {p['rounds']}, {p['log_R']}, "
                            f"{p['log_G']}, {p['blocks']}, "
                            f"{p['smem_bytes']}, {p['registers']}, "
                            f"{p['ms']:.4f})"
                            for p in entry["passes"])
                + (f", plain {entry['plain_ms']:.1f} ms"
                   if "plain_ms" in entry else ""))
            del x, out, launches
            torch.cuda.empty_cache()
        main = by_shape[0]
        rows.append(dict(
            name=name, route="cuda",
            source="certificate_stark_tpu_torch/csrc/ntt.cu",
            replaces=("certificate_stark_tpu/ops/ntt.py:97" if name == "ntt"
                      else "certificate_stark_tpu/ops/ntt.py:326"),
            max_abs_err=err[name], library_ms=None, shape=main["shape"],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            ms_by_shape=by_shape, checks=count[name], **use))
    return rows


def _ext_muls(d):
    """32-bit multiplies of one extension multiply (d = 1: a Montgomery
    multiply; else d^2 products summed unreduced, 2d - 1 reductions)."""
    return MULS_PER_MMUL if d == 1 else d * d * MULS_PER_MAC \
        + (2 * d - 1) * MULS_PER_REDC


def _ood_cost(d, w, k, m, old=False):
    """(bytes, 32-bit multiplies, int8 tensor-core operations) of ood:
    the coefficients read once and the [d, 2w + k] values written; an
    index's 2 d w trace and d^2 k composition products as byte-sliced
    exact integer products (8 x 8 byte products each, counted once, a
    multiply-add two operations), and one extension multiply an index and
    point for the powers on the CUDA cores. `old`: PR 18's count, every
    product as MULS_PER_MAC 32-bit multiplies into an unreduced sum."""
    prods = 2 * d * w + d * d * k
    nbytes = 8 * (w + d * k) * m + 8 * d * (2 * w + k)
    if old:
        return nbytes, m * (prods * MULS_PER_MAC + 3 * _ext_muls(d)), 0
    return nbytes, m * 3 * _ext_muls(d), m * prods * 64 * 2


def _deep_cost(d, w, k, S, old=False):
    """(bytes, 32-bit multiplies, int8 tensor-core operations) of deep:
    a point's w trace and d k composition values and its x read, d values
    written (a block's sums of the OOD values, some d^2 (2 w + k)
    products, left out); a point's 2 d w + d^2 k products as byte-sliced
    exact integer products (8 x 8 byte products each, counted once, a
    multiply-add two operations); on the CUDA cores the 4 d - 1
    reductions of the sums (2 d for the two trace sums, 2 d - 1 for the
    composition's) and 11 extension multiplies (three denominators' pair
    products and their product, three numerator terms, and Montgomery's
    trick over the domain: a prefix product, two on the way back, the
    quotient). The one inversion the whole domain needs is left out; the
    kernel's one a run of points is its own choice. `old`: PR 18's count,
    every product as MULS_PER_MAC 32-bit multiplies into an unreduced
    sum."""
    prods = 2 * d * w + d * d * k
    epi = (4 * d - 1) * MULS_PER_REDC + 11 * _ext_muls(d)
    nbytes = 8 * S * (w + d * k + 1 + d)
    if old:
        return nbytes, S * (prods * MULS_PER_MAC + epi), 0
    return nbytes, S * epi, S * prods * 64 * 2


def _fold_cost(d, fold, L, old=False):
    """Bytes (fold d values read, d written a point) and 32-bit multiplies
    of fri_fold: 1/x from one table product; fold 2 then 2 d Montgomery
    multiplies (by 1/x, and the one 1/2) and one extension multiply by xi;
    fold 4 1/(x w^step) and 1/x^2 (a squaring), 4 d Montgomery multiplies
    and three extension multiplies by xi or xi^2, each a constant: d sums
    of d products, each reduced once (csrc/deep.cu fold_point). `old`:
    the count of radix-2 folds in turn, each 2 d + 1 Montgomery multiplies
    and one extension multiply, fold 4 three of them, and xi^2 an
    extension multiply a point."""
    ext = _ext_muls(d)
    if old:
        halves = fold - 1
        per = halves * ((2 * d + 1) * MULS_PER_MMUL + ext) \
            + (MULS_PER_MMUL if fold == 2 else 3 * MULS_PER_MMUL + ext)
        return 8 * d * L * (fold + 1), L * per
    by_const = MULS_PER_MMUL if d == 1 else \
        d * d * MULS_PER_MAC + d * MULS_PER_REDC
    if fold == 2:
        per = (2 * d + 1) * MULS_PER_MMUL + by_const
    else:
        per = (4 * d + 2) * MULS_PER_MMUL + MULS_PER_MSQR + 3 * by_const
    return 8 * d * L * (fold + 1), L * per


def _tail_inputs(rand, name, shape):
    """Random inputs of a recorded shape: (args, kwargs) of the wrapper."""
    from certificate_stark_tpu_torch.ops import field as F
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.utils import poly_host as PH
    if name == "ood":
        d, w, k, m, s = shape
        return (rand(w, m), rand(d, k, m), rand(d, 3), s), {}
    if name == "deep":
        d, w, k, S = shape
        return (rand(w, S), rand(d, k, S), rand(S), rand(d, 3), rand(d, w),
                rand(d, w), rand(d, k), rand(d, w), rand(d, w),
                rand(d, k)), {}
    d, fold, L, size, j0 = shape
    # a whole layer's leaf rows, or a rank's; xi as the coin draws it
    groups = rand(fold, d, L)
    layer = K.FoldLayer(F.GENERATOR, PH.root_of_unity(size), size, fold,
                        groups.device)
    return (groups, rand(d).tolist(), layer), dict(j0=j0)


def _tail_plain(K, name, args, kw, out):
    """max |kernel - plain| of one call, the plain version on ood's column
    groups or deep's point slices (their temporaries are many times the
    input); fri_fold in both output modes: `out` the values [d, L], and
    the kernel's leaf rows of folding `fold` against the plain version's
    (engine/fri.py leaf_rows of its values) where L / fold is a power of
    two."""
    from certificate_stark_tpu_torch.engine import fri as FRI
    if name == "fri_fold":
        fold, _, L = args[0].shape
        m = L // fold
        rows = K.fri_fold(*args, out_fold=fold, **kw) \
            if L % fold == 0 and m & (m - 1) == 0 else None
        with K.plain_versions():
            exp = K.fri_fold(*args, **kw)
        err = int((out - exp).abs().max())
        if rows is not None:
            err = max(err, int((rows - FRI.leaf_rows(exp, fold)).abs()
                               .max()))
        return err
    with K.plain_versions():
        if name == "ood":
            coef, h, pts, s = args
            w, k, G = coef.shape[0], h.shape[1], TAIL_PLAIN_COLS
            err = 0
            for c0 in range(0, max(w, k), G):
                exp = K.ood(coef[c0:c0 + G], h[:, c0:c0 + G], pts, s)
                cw, ck = exp[0].shape[1], exp[2].shape[1]
                for got, e, n in ((out[0][:, c0:c0 + cw], exp[0], cw),
                                  (out[1][:, c0:c0 + cw], exp[1], cw),
                                  (out[2][:, c0:c0 + ck], exp[2], ck)):
                    if n:
                        err = max(err, int((got - e).abs().max()))
            return err
        lde, h, xs, *rest = args
        S, err = xs.shape[0], 0
        for i in range(0, S, TAIL_PLAIN_POINTS):
            sl = slice(i, i + TAIL_PLAIN_POINTS)
            exp = K.deep(lde[:, sl], h[..., sl], xs[sl], *rest)
            err = max(err, int((out[:, sl] - exp).abs().max()))
        return err


def phase_tail(dev, shapes=None):
    """ood, deep and fri_fold (csrc/deep.cu) bit for bit against their
    plain versions on random inputs at every shape in `shapes` (the
    wrappers' records of the paths run, the sharded ranks' among them:
    {"ood": {(d, w, k, m, s)}, "deep": {(d, w, k, S)}, "fri_fold": {(d,
    fold, L, size, j0)}}) and at OOD_MAIN, DEEP_MAIN, FOLD_MAIN and
    FOLD_MORE, fri_fold in both output modes; deep also with domain points
    equal to z (d = 1), whose values must be 0. Then each timed (CUDA
    events; a call as the prover calls it, and on the device alone from a
    CUDA graph) at its *_TIMED shapes beside its bound by the kernel's
    count and by the earlier one (`old`), the plain version's time at the
    row's shape, and the ptxas report (every instantiation); fri_fold also
    writing the next layer's leaf rows (`ms_rows`, `device_ms_rows`).
    Returns the three rows of the kernels line."""
    from certificate_stark_tpu_torch.ops import kernels as K
    rand = _randoms(dev)
    fns = {"ood": K.ood, "deep": K.deep, "fri_fold": K.fri_fold}
    main = {"ood": OOD_MAIN, "deep": DEEP_MAIN,
            "fri_fold": FOLD_MAIN + FOLD_MORE}
    err = {name: 0 for name in fns}
    count = {name: 0 for name in fns}
    t0 = time.perf_counter()
    for name, fn in fns.items():
        todo = set(main[name]) | set((shapes or {}).get(name, ()))
        for shape in sorted(todo):
            args, kw = _tail_inputs(rand, name, shape)
            out = fn(*args, **kw)
            e = _tail_plain(K, name, args, kw, out)
            err[name] = max(err[name], e)
            count[name] += 1
            check(e == 0, f"{name} differs from its plain version at "
                  f"{shape}")
            del args, out
        torch.cuda.empty_cache()
    # zero denominators: domain points equal to z at d = 1
    args, _ = _tail_inputs(rand, "deep", (1, TAIL_W, TAIL_K, 1 << 12))
    xs, pts = args[2], args[3]
    xs[[5, 700, 4000]] = pts[0, 0]
    got = K.deep(*args)
    check(int(got[:, [5, 700, 4000]].abs().max()) == 0 and
          _tail_plain(K, "deep", args, {}, got) == 0,
          "deep: a zero denominator's point is not 0")
    extra = _tail_limits(K, rand, dev)
    torch.cuda.synchronize()
    log(f"ood, deep, fri_fold == plain: {count['ood']}, {count['deep']} and "
        f"{count['fri_fold']} shapes ({len((shapes or {}).get('ood', ()))}, "
        f"{len((shapes or {}).get('deep', ()))} and "
        f"{len((shapes or {}).get('fri_fold', ()))} of them recorded on "
        f"the paths), bit for bit; deep's zero denominators give 0; "
        f"{extra}; {time.perf_counter() - t0:.1f} s")

    rows = []
    for name, timed, cost, where, kern in (
            ("ood", OOD_TIMED, lambda s, old=False: _ood_cost(*s[:4], old),
             "certificate_stark_tpu/engine/prover.py:748",
             ("ood_kernelILi1E", "ood_kernelILi2E", "ood_kernelILi3E",
              "ood_pow_kernelILi3E", "ood_total_kernelILi3E")),
            ("deep", DEEP_TIMED, lambda s, old=False: _deep_cost(*s, old),
             "certificate_stark_tpu/engine/prover.py:802",
             ("deep_kernelILi1E", "deep_kernelILi2E", "deep_kernelILi3E")),
            ("fri_fold", FOLD_TIMED,
             lambda s, old=False: _fold_cost(*s[:3], old),
             "certificate_stark_tpu/engine/prover.py:1088",
             tuple(f"fri_fold_kernelILi{d}ELi{f}E" for d in (1, 2, 3)
                   for f in (2, 4)))):
        uses = {k: _ptxas_usage("deep", k) for k in kern}
        for u in uses.values() if name == "fri_fold" else ():
            if u.get("registers"):  # blocks of 256 threads an SM resident
                u["blocks_per_sm"] = min(
                    8, 65536 // (256 * 8 * -(-u["registers"] // 8)))
        log(f"{name}: ptxas " + "; ".join(f"{k} {u}" for k, u in
                                          uses.items()))
        by_shape = []
        fn = fns[name]
        for shape in timed:
            args, kw = _tail_inputs(rand, name, shape)
            call = lambda: fn(*args, **kw)                      # noqa: E731
            ms = cuda_ms(call, 5)
            dev_ms = graph_ms(call, 10)
            bnd, by = bound_ms(*cost(shape))
            entry = dict(shape=list(shape), ms=ms, device_ms=dev_ms,
                         bound_ms=bnd, bound_by=by)
            # the earlier count, for its shares
            entry["bound_ms_old"], entry["bound_by_old"] = bound_ms(
                *cost(shape, True))
            if name == "fri_fold":   # into the next layer's leaf rows
                to_rows = lambda: fn(*args, out_fold=shape[1],  # noqa: E731
                                     **kw)
                entry["ms_rows"] = cuda_ms(to_rows, 5)
                entry["device_ms_rows"] = graph_ms(to_rows, 10)
            if shape == timed[0]:
                torch.cuda.empty_cache()
                _plain_timed(call)
                entry["plain_ms"] = _plain_timed(call)[1]
            by_shape.append(entry)
            log(f"{name} {shape}: a call {ms:.4f} ms, device {dev_ms:.4f} ms "
                f"(a CUDA graph of 10), bound {bnd:.4f} ms ({by}; "
                f"{100 * bnd / ms:.1f}% of a call)"
                + (f", PR 18's bound {entry['bound_ms_old']:.4f} ms "
                   f"({entry['bound_by_old']})"
                   if "bound_ms_old" in entry else "")
                + (f"; into leaf rows: a call {entry['ms_rows']:.4f} ms, "
                   f"device {entry['device_ms_rows']:.4f} ms"
                   if "ms_rows" in entry else "")
                + (f", plain {entry['plain_ms']:.1f} ms"
                   if "plain_ms" in entry else ""))
            del args, kw, call
            torch.cuda.empty_cache()
        row = by_shape[0]
        shape = row["shape"]
        use = uses[kern[shape[0] - 1] if name != "fri_fold" else
                   f"fri_fold_kernelILi{shape[0]}ELi{shape[1]}E"]
        rows.append(dict(
            name=name, route="cuda",
            source="certificate_stark_tpu_torch/csrc/deep.cu",
            replaces=where, max_abs_err=err[name], library_ms=None,
            **{k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by")},
            ms_by_shape=by_shape, checks=count[name], ptxas=uses, **use))
    return rows


def _tail_limits(K, rand, dev):
    """ood and deep on every value p - 1 at the 1024-transaction shapes,
    deep at the widest trace and composition it takes (K.DEEP_MAX_W,
    K.DEEP_MAX_K, d = 3) and ood as wide, on random values, on p - 1 and
    on the canonical value with the most bytes 0xFF (the largest sums of
    byte products), all bit for bit against their plain versions; deep
    refusing one column more of either; fri_fold on p - 1 (values and xi)
    at 2^20 -> 2^18 points, d = 1, 3, in both output modes, and from a
    strided view of the layer's values (the route before the rows
    output) and from a view at
    an odd offset. Returns a line for the log."""
    from certificate_stark_tpu_torch.utils import poly_host as PH

    def full(v):
        return lambda *shape: torch.full(shape, v, dtype=torch.int64,
                                         device=dev)
    worst = full(K.P - 1)
    checks = 0
    for d in (1, 3):
        m = 1 << 20
        args = (worst(TAIL_W, m), worst(d, TAIL_K, m), rand(d, 3), 0)
        e = _tail_plain(K, "ood", args, {}, K.ood(*args))
        check(e == 0, f"ood differs from its plain version on p - 1, d {d}")
        args = (worst(TAIL_W, m), worst(d, TAIL_K, m), rand(m), rand(d, 3),
                rand(d, TAIL_W), rand(d, TAIL_W), rand(d, TAIL_K),
                worst(d, TAIL_W), worst(d, TAIL_W), worst(d, TAIL_K))
        e = max(e, _tail_plain(K, "deep", args, {}, K.deep(*args)))
        check(e == 0, f"deep differs from its plain version on p - 1, "
              f"d {d}")
        checks += 2
        del args
        size = 1 << 20
        layer = K.FoldLayer(K.P - 1 if d == 3 else 7,
                            PH.root_of_unity(size), size, 4, dev)
        vals = rand(d, size)
        views = (worst(4, d, size // 4),
                 vals.reshape(d, 4, size // 4).transpose(0, 1),
                 rand(4 * d * size // 4 + 1)[1:].reshape(4, d, size // 4))
        for xi, groups in zip(([K.P - 1] * d, rand(d).tolist(),
                               rand(d).tolist()), views):
            args = (groups, xi, layer)
            e = _tail_plain(K, "fri_fold", args, {}, K.fri_fold(*args))
            check(e == 0, f"fri_fold differs from its plain version on "
                  f"p - 1 or a view, d {d}")
            checks += 1
        del vals, views, args
    W, Kc, S = K.DEEP_MAX_W, K.DEEP_MAX_K, 1 << 14
    for fill in (rand, worst, full(0x40FFFFFFFFFFFFFF)):
        args = (fill(W, S), fill(3, Kc, S), rand(S), rand(3, 3),
                rand(3, W), rand(3, W), rand(3, Kc), fill(3, W), fill(3, W),
                fill(3, Kc))
        e = _tail_plain(K, "deep", args, {}, K.deep(*args))
        check(e == 0, f"deep differs from its plain version at w = {W}, "
              f"k = {Kc}")
        args = (fill(W, S), fill(3, Kc, S), rand(3, 3), 5)
        e = max(e, _tail_plain(K, "ood", args, {}, K.ood(*args)))
        check(e == 0, f"ood differs from its plain version at w = {W}, "
              f"k = {Kc}")
        checks += 2
    for w, k in ((W + 1, Kc), (W, Kc + 1)):
        args = (rand(w, 64), rand(3, k, 64), rand(64), rand(3, 3),
                rand(3, w), rand(3, w), rand(3, k), rand(3, w), rand(3, w),
                rand(3, k))
        try:
            K.deep(*args)
        except ValueError:
            continue
        check(False, f"deep took w = {w}, k = {k}")
    return (f"p - 1, the most bytes 0xFF, fri_fold's views and w = {W}, "
            f"k = {Kc}: {checks} checks, "
            f"bit for bit; deep refuses w = {W + 1} and k = {Kc + 1}")


@contextlib.contextmanager
def _tail_before_kernels():
    """The prover's tail as it ran before the ood, deep and fri_fold
    kernels: their plain versions called outside plain_versions(), so
    that each field multiply is an f63_mul launch."""
    from certificate_stark_tpu_torch.ops import kernels as K
    saved = K.ood, K.deep, K.fri_fold

    def deep(*args, out=None):
        q = K.deep_plain(*args)
        return q if out is None else out.copy_(q)
    K.ood, K.deep, K.fri_fold = K.ood_plain, deep, K.fri_fold_plain
    try:
        yield
    finally:
        K.ood, K.deep, K.fri_fold = saved


def _tail_spans(prover, what):
    """The proof's tail of `prover`'s path apart from the coin draws:
    phase_ood, phase_deep (every segment) and the FRI folds (every layer,
    no commitments) on random inputs of its shapes, each timed (CUDA
    events, and the host wall of one synchronized call) through the
    kernels and through the PyTorch route they replaced
    (_tail_before_kernels), with its launches and the peak device memory
    it adds. The FRI folds run as the prover runs them (the first layer's
    leaf rows copied from the DEEP values, each fold writing the next
    layer's rows, the last one the remainder) and, through the kernels
    only, as a loop that copies every layer's rows (each fold reading a
    strided view of the layer's values)."""
    from certificate_stark_tpu_torch.engine import fri as FRI
    from certificate_stark_tpu_torch.ops import kernels as K
    rand = _randoms(prover.device)
    d, w, k, n, bn = prover.d, prover.w, prover.k, prover.n, prover.bn
    coeffs, h_coeffs, z = rand(w, n), rand(d, k, n), rand(d)
    lde, h_lde = rand(w, bn), rand(d, k, bn)
    oods = prover.phase_ood(coeffs, h_coeffs, z)
    g = (rand(d, w), rand(d, w), rand(d, k))
    evals, xi = rand(d, bn), rand(d).tolist()
    fold, plan = prover.opts.fri_folding, prover.fri_plan

    def folds():
        rows = FRI.leaf_rows(evals, fold)
        for i, layer in enumerate(plan):
            rows = FRI.fold(rows, xi, layer,
                            0 if i + 1 == len(plan) else fold)
        return rows

    def folds_copying():
        cur = evals
        for layer in plan:
            FRI.leaf_rows(cur, fold)
            cur = K.fri_fold(cur.reshape(d, fold, -1).transpose(0, 1), xi,
                             layer)
        return cur

    out = {}
    for label, fn, routes in (
            ("phase_ood", lambda: prover.phase_ood(coeffs, h_coeffs, z),
             ("kernels", "before")),
            ("phase_deep", lambda: prover.phase_deep(lde, h_lde, *oods, *g,
                                                     z),
             ("kernels", "before")),
            ("FRI folds", folds, ("kernels", "before")),
            ("FRI folds, copying every layer", folds_copying,
             ("kernels",))):
        res = {}
        for route in routes:
            ctx = _tail_before_kernels() if route == "before" \
                else contextlib.nullcontext()
            with ctx:
                fn()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launches()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                counts = {f.__name__: f.launches for f in K.WRAPPERS
                          if f.launches}
                peak = (torch.cuda.max_memory_allocated() - base) / 2**20
                ms = cuda_ms(fn, 3)
            res[route] = dict(ms=ms, wall_ms=wall, peak_mib=peak,
                              launches=counts)
        out[label] = res
        kr, br = res["kernels"], res.get("before")
        log(f"  {what}, {label} apart from the coin draws: kernels "
            f"{kr['ms']:.3f} ms (wall {kr['wall_ms']:.3f} ms, "
            f"+{kr['peak_mib']:.0f} MiB, launches {kr['launches']})"
            + (f"; the PyTorch route before them {br['ms']:.2f} ms (wall "
               f"{br['wall_ms']:.2f} ms, +{br['peak_mib']:.0f} MiB, "
               f"launches {br['launches']})" if br else ""))
    del coeffs, h_coeffs, lde, h_lde, evals
    torch.cuda.empty_cache()
    return out


def _fri_profile(prover, what):
    """One warm FRI phase of `prover` (Prover._fri_layers on random DEEP
    values: the commits, the coin's reseeds and draws and the folds) under
    torch.profiler: its wall, and the device's ops by name with their
    launches; PyTorch's copy kernels (`direct_copy_kernel_cuda`, a
    `leaf_rows` copy) apart from the memory copies (the roots read
    back)."""
    from torch.profiler import ProfilerActivity, profile
    from certificate_stark_tpu_torch.engine.coin import RandomCoin
    deep = _randoms(prover.device)(prover.d, prover.bn)

    def phase():
        layers, rem = prover._fri_layers(RandomCoin(prover.hasher, [1, 2]),
                                         deep, None)
        torch.cuda.synchronize()
        return layers, rem
    phase()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        layers = phase()[0]
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_by_name(prof)
    copies = {k: v for k, v in by_name.items() if "copy_kernel" in k}
    dev_ms = sum(t for t, _ in by_name.values())
    log(f"  {what}, one warm FRI phase ({len(layers)} layers) under "
        f"torch.profiler: wall {wall:.2f} ms, device {dev_ms:.3f} ms, "
        f"{sum(c for _, c in by_name.values())} device ops; PyTorch copies "
        f"{sum(c for _, c in copies.values())}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        log(f"    {t:8.4f} ms {c:4d}x {name[:100]}")
    return dict(layers=len(layers), wall_ms=wall, device_ms=dev_ms,
                ops={k[:100]: [t, c] for k, (t, c) in by_name.items()},
                copies=sum(c for _, c in copies.values()))


def phase_tail_paths(dev):
    """`--deep`'s spans: _tail_spans on provers of the 128- and
    1024-transaction AIRs (tables only, no witness), with bench.py's
    options and the example CLI's cubic ones; _fri_profile of the cubic
    128-transaction one."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.utils import curve as CV
    CV.set_curve("fp2")
    out = {}
    for count in (TX_COUNT, TX1024):
        for key, od in (("base", BENCH_OPTS), ("cubic", CLI_OPTS)):
            air = TX.TransactionAir(count * TX.CYCLE, ([1] * 7, [2] * 7),
                                    ProofOptions(**od), depth=TX_DEPTH)
            prover = Prover(air, device=dev)
            out[f"{count}tx_{key}"] = _tail_spans(
                prover, f"{count} tx, {key}")
            if count == TX_COUNT and key == "cubic":
                out["fri_profile"] = _fri_profile(prover,
                                                  f"{count} tx, {key}")
            del prover
            torch.cuda.empty_cache()
    return out


def phase_chunked128(dev, ex, raw):
    """The 128-transaction proof of ex (bench.py's options) with a forced
    chunk of an eighth of its domain: the same bytes as the unchunked
    proof `raw`."""
    from certificate_stark_tpu_torch.engine.prover import Prover
    air = ex.air()
    prover = Prover(air, device=dev,
                    chunk=air.trace_length * ex.options.blowup // 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = prover.prove(ex.trace).to_bytes()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    sha = hashlib.sha256(got).hexdigest()
    check(got == raw, f"{TX_COUNT} tx: the proof in segments of "
          f"{prover.chunk} differs from the unchunked one")
    check(sha == TX128_SHA256, f"{TX_COUNT} tx: proof {sha} differs from "
          f"the pinned {TX128_SHA256}")
    log(f"{TX_COUNT} tx, bench options, in {prover.bn // prover.chunk} "
        f"segments of {prover.chunk}: {ms:.1f} ms (trace build included), "
        f"equal to the unchunked proof, sha256 {sha} ({len(got)} B)")


# The sharded prover (certificate_stark_tpu_torch/parallel/). The default
# run's phase_parallel: 4 ranks sharing the one card over gloo (named; the
# ranks hand their CUDA tensors to gloo through host copies), proving these
# goldens of tests/vectors/torch_goldens.json and the 128-transaction base
# proof. `--parallel`: 4 ranks, one card each, over NCCL, proving the 128-
# and 1024-transaction proofs below, each beside the single-card proof of
# the same trace in that run.
PARALLEL_RANKS = 4
PARALLEL_GOLDENS = ("transaction_16tx_d15_blake3", "rescue_chain1024_rescue",
                    "transaction_2tx_d3_cubic_blake3")
# the 128-transaction proof with the example CLI's cubic defaults (the bytes
# every run since PR 8 printed)
TX128_CUBIC = ("893676f59d80aa3aca336d0e19113b44"
               "9595ebde50a782a0da0894f381fa27d8", 395588)


def _air_of(recipe):
    """An AIR from its picklable recipe (kind, trace length, public
    inputs, options, depth)."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    from certificate_stark_tpu_torch.models import transaction as TX
    kind, n, pub, od, depth = recipe
    if kind == "tx":
        return TX.TransactionAir(n, pub, ProofOptions(**od), depth=depth)
    return RC.RescueChainAir(n, pub, ProofOptions(**od))


def _sharded_rank(mesh, jobs, warm):
    """One rank of the sharded proofs: for each job, a ShardedProver on
    the job's AIR and the whole trace (read from the job's file), a warm-up
    proof where `warm`, then the counted run: launch counts and collective
    statistics set to 0 just before, read just after, with the phase spans,
    each collective's ms (the device synchronized around it, so a wait for
    the slowest rank counts) and the peak device memory; then the wall of
    a proof with neither spans nor collective timing, the same bytes.
    Returns {job: its results}."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.parallel.prover import ShardedProver
    from certificate_stark_tpu_torch.utils import curve as CV
    dev = mesh.device

    @contextlib.contextmanager
    def timed(kind):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(dev)
        s = mesh.stats[kind]
        s["ms"] = s.get("ms", 0.0) + (time.perf_counter() - t0) * 1e3

    out = {}
    for job in jobs:
        CV.set_curve("fp2")
        trace = torch.load(job["trace"], map_location=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        prover = ShardedProver(_air_of(job["air"]), mesh)
        torch.cuda.synchronize(dev)
        setup_ms = (time.perf_counter() - t0) * 1e3
        setup_peak = torch.cuda.max_memory_allocated(dev) - before
        if warm:
            prover.prove(trace)
        spans, t_last = [], [0.0]

        def mark(label):
            torch.cuda.synchronize(dev)
            now = time.perf_counter()
            spans.append((label, (now - t_last[0]) * 1e3))
            t_last[0] = now

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mesh.reset_stats()
        K.reset_launches()
        mesh.timer = timed
        t0 = t_last[0] = time.perf_counter()
        try:
            raw = prover.prove(trace, mark=mark).to_bytes()
        finally:
            mesh.timer = None
        timed_ms = (time.perf_counter() - t0) * 1e3
        res = dict(
            raw=raw, timed_ms=timed_ms, setup_ms=setup_ms,
            setup_peak=setup_peak, spans=spans,
            stats=copy.deepcopy(mesh.stats),
            launches={fn.__name__: fn.launches for fn in K.WRAPPERS},
            peak=torch.cuda.max_memory_allocated(dev),
            block=(prover.j_lo, prover.j_hi), chunk=prover.chunk,
            shapes={fn.__name__: set(fn.shapes) for fn in (
                K.ntt, K.lde, K.ood, K.deep, K.fri_fold)})
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        again = prover.prove(trace).to_bytes()
        torch.cuda.synchronize(dev)
        res["wall_ms"] = (time.perf_counter() - t0) * 1e3
        check(again == raw, f"sharded {job['name']}: rank {mesh.rank}'s "
              "proof differs between two runs")
        out[job["name"]] = res
        del prover, trace
        torch.cuda.empty_cache()
    return out


def _save_trace(name, trace):
    """The trace on the host, in a file under build/ the ranks read."""
    path = os.path.join(OUT, "parallel", f"{name}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(trace.cpu().contiguous(), path)
    return path


def _job(name, ex, trace_path, expected, what):
    """A sharded proof for the ranks: ex's AIR as a recipe, the file of its
    trace (_save_trace), the pinned (sha256, length) its bytes must
    have."""
    import dataclasses
    return dict(name=name, what=what, expected=expected, trace=trace_path,
                air=("tx" if hasattr(ex, "md") else "chain",
                     ex.air().trace_length, ex.pub_inputs(),
                     dataclasses.asdict(ex.options),
                     getattr(ex, "depth", None)))


def _report_sharded(jobs, results, backend, singles=None):
    """Checks that every rank returned the same bytes, equal to the job's
    pinned (sha256, length), and prints each rank's walls and counted run:
    set-up, phase spans, collectives (calls, bytes, ms, share of the
    instrumented wall), peak memory and launches; with the single-card
    wall of the same proof where `singles` has it. Returns {job: launches
    summed over the ranks}."""
    from certificate_stark_tpu_torch.engine.proof import Proof
    D = len(results)
    summed = {}
    for job in jobs:
        name = job["name"]
        per = [r[name] for r in results]
        raws = {p["raw"] for p in per}
        check(len(raws) == 1, f"sharded {name}: the ranks' proofs differ")
        raw = per[0]["raw"]
        sha = hashlib.sha256(raw).hexdigest()
        check((sha, len(raw)) == job["expected"],
              f"sharded {name}: proof {sha} ({len(raw)} B) differs from "
              f"the pinned {job['expected']}")
        walls = [p["wall_ms"] for p in per]
        line = (f"sharded {name} ({job['what']}), {D} ranks over "
                f"{backend}: wall {max(walls):.1f} ms (slowest rank, "
                f"uninstrumented; {', '.join(f'{w:.1f}' for w in walls)}; "
                f"instrumented {max(p['timed_ms'] for p in per):.1f})")
        if singles and name in singles:
            line += f"; one card, same trace: {singles[name]:.1f} ms"
        log(line + f"; every rank's proof equals the pinned {sha[:16]}... "
            f"({len(raw)} B)")
        for r, p in enumerate(per):
            coll = sum(s["ms"] for s in p["stats"].values())
            log(f"  rank {r}: points [{p['block'][0]}, {p['block'][1]}) in "
                f"segments of {p['chunk']}; set-up {p['setup_ms']:.1f} ms, "
                f"{p['setup_peak'] / 2**20:.0f} MiB at its peak; "
                f"collectives {coll:.1f} ms = "
                f"{100 * coll / p['timed_ms']:.1f}% of its instrumented "
                f"wall; peak device memory {p['peak'] / 2**20:.0f} MiB")
            log("    " + "; ".join(f"{lb} {ms:.1f}" for lb, ms in p["spans"]))
            log("    " + "; ".join(
                f"{k} {s['calls']} calls {s['bytes'] / 2**20:.2f} MiB "
                f"{s['ms']:.1f} ms" for k, s in sorted(p["stats"].items())))
            log(f"    launches {p['launches']}")
        total = {k: sum(p["launches"][k] for p in per)
                 for k in per[0]["launches"]}
        hash_fn = job["air"][3]["hash_fn"]
        for k in ("f63_mul", "ntt") + (("rescue_permutation",) if hash_fn ==
                                        "rescue" else (f"{hash_fn}_leaves",
                                                       f"{hash_fn}_tree")):
            check(all(p["launches"][k] > 0 for p in per),
                  f"sharded {name}: {k} not launched on every rank")
        # one evaluation (transaction AIR) and composition a segment a rank
        for p in per:
            segments = (p["block"][1] - p["block"][0]) // p["chunk"]
            check(p["launches"]["compose"] == segments and
                  p["launches"]["transaction_eval"] ==
                  (segments if job["air"][0] == "tx" else 0),
                  f"sharded {name}: not one transaction_eval and compose "
                  f"launch a segment on every rank ({p['launches']})")
            _check_tail(p["launches"], segments,
                        len(Proof.from_bytes(raw).fri_roots),
                        f"sharded {name}, a rank")
        summed[name] = total
    return summed


def _remove_traces(jobs):
    for path in {job["trace"] for job in jobs}:
        if os.path.exists(path):
            os.remove(path)


def phase_parallel(dev, ex):
    """The sharded prover on the one card: PARALLEL_RANKS ranks over gloo
    (named), every rank on cuda:0, proving PARALLEL_GOLDENS and the
    128-transaction base proof of ex (bench options), each rank's proof
    equal to the pinned bytes. The kernels are built (phase_build) before
    the ranks start; the ranks only load them. Returns the launches of the
    128-transaction run summed over the ranks (`sharded4_tx128`), and the
    shapes the ranks launched of ntt, lde (for phase_ntt), ood, deep and
    fri_fold (for phase_tail)."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.models import rescue_chain as RC
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.parallel import mesh as PM
    from certificate_stark_tpu_torch.utils import curve as CV
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        goldens = json.load(f)
    t0 = time.perf_counter()
    jobs = []
    for name in PARALLEL_GOLDENS:
        g = goldens[name]
        opts = ProofOptions(**g["options"])
        if "curve" in g:
            CV.set_curve(g["curve"])
            gx = TX.TransactionExample(g["num_transactions"], opts,
                                       depth=g["depth"], seed=g["seed"],
                                       device=dev)
        else:
            gx = RC.RescueChainExample(g["chain_length"], opts, device=dev)
        jobs.append(_job(name, gx, _save_trace(name, gx.trace),
                         (g["proof_sha256"], g["proof_len"]), "golden"))
    jobs.append(_job("tx128", ex, _save_trace("tx128", ex.trace),
                     (TX128_SHA256, 366852),
                     f"{TX_COUNT} tx depth {TX_DEPTH}, bench options"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        results = PM.launch(_sharded_rank, PARALLEL_RANKS, "gloo",
                            device="cuda:0", args=(jobs, False), timeout=600)
    finally:
        _remove_traces(jobs)
    log(f"phase_parallel: {PARALLEL_RANKS} ranks on one card over gloo: "
        f"{time.perf_counter() - t0:.1f} s (spawn included), traces and "
        f"witnesses {prep:.1f} s")
    launches = _report_sharded(jobs, results, "gloo")
    shapes = {k: set() for k in ("ntt", "lde") + TAIL_KERNELS}
    for res in results:
        for job in res.values():
            for k in shapes:
                shapes[k] |= job["shapes"][k]
    return launches["tx128"], shapes


def _single_card(dev, air, trace):
    """The single-card proof of `trace`: a warm-up, then one proof timed
    on a Prover built before (no trace build) -> (ms, bytes)."""
    from certificate_stark_tpu_torch.engine.prover import Prover
    prover = Prover(air, device=dev)
    prover.prove(trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = prover.prove(trace).to_bytes()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, raw


def _launch_nccl(jobs):
    """The jobs on PARALLEL_RANKS ranks, one card each, over NCCL, every
    rank warm before its counted runs; the trace files removed after."""
    from certificate_stark_tpu_torch.parallel import mesh as PM
    t0 = time.perf_counter()
    try:
        results = PM.launch(_sharded_rank, PARALLEL_RANKS, "nccl",
                            args=(jobs, True), timeout=480)
    finally:
        _remove_traces(jobs)
    log(f"{PARALLEL_RANKS} ranks over nccl, {len(jobs)} proofs: "
        f"{time.perf_counter() - t0:.1f} s (spawn and warm-ups included)")
    return results


def run_parallel(dev, witness, t_start):
    """`--parallel`: PARALLEL_RANKS ranks, one card each, over NCCL (fewer
    cards raise), proving the 128-transaction base, SHA-256 and cubic
    proofs and the 1024-transaction base and cubic proofs (the witness
    built once, in the worker start_witness started), each equal to its
    pinned bytes, each beside the single-card wall of the same trace in
    this run; every rank warm before its counted run. Every wall is taken
    after the witness worker has ended, so none shares the host with
    it."""
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.utils import curve as CV
    log(subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                       text=True).stdout)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for i, line in enumerate(cards):
        log(f"card {i}: {line}")
    check(torch.cuda.device_count() >= PARALLEL_RANKS,
          f"--parallel needs {PARALLEL_RANKS} cards, "
          f"{torch.cuda.device_count()} found")
    with open(os.path.join(ROOT, "tests", "vectors", TX1024_VECTOR)) as f:
        pin = json.load(f)
    CV.set_curve("fp2")
    t0 = time.perf_counter()
    ex = TX.TransactionExample(TX_COUNT, ProofOptions(**BENCH_OPTS),
                               depth=TX_DEPTH, device=dev)
    log(f"witness, {TX_COUNT} tx depth {TX_DEPTH}: "
        f"{time.perf_counter() - t0:.1f} s")
    proc, recv = witness
    t0 = time.perf_counter()
    big, secs = recv.recv()
    proc.join()
    log(f"witness, {TX1024} tx depth {TX_DEPTH} (worker): {secs:.1f} s; "
        f"waited {time.perf_counter() - t0:.1f} s")
    big.device = dev
    jobs, singles = [], {}
    for base, count, paths in (
            (ex, TX_COUNT, (
                ("tx128", BENCH_OPTS, (TX128_SHA256, 366852),
                 "bench options"),
                ("tx128_sha256", dict(BENCH_OPTS, hash_fn="sha256"),
                 TX128_SHA256_PATH, "bench options, SHA-256"),
                ("tx128_cubic", CLI_OPTS, TX128_CUBIC,
                 "cubic, BLAKE3 (the example CLI's defaults)"))),
            (big, TX1024, (
                ("tx1024", BENCH_OPTS,
                 (pin["proof_sha256"], pin["proof_len"]), "bench options"),
                ("tx1024_cubic", CLI_OPTS, (pin["cubic_proof_sha256"],
                                            pin["cubic_proof_len"]),
                 "cubic, BLAKE3 (the example CLI's defaults)")))):
        trace = base.trace
        trace_path = _save_trace(f"tx{count}", trace)
        for key, od, expected, what in paths:
            path = copy.copy(base)
            path.options = ProofOptions(**od)
            torch.cuda.reset_peak_memory_stats()
            singles[key], raw = _single_card(dev, path.air(), trace)
            check((hashlib.sha256(raw).hexdigest(), len(raw)) == expected,
                  f"{key}: the single-card proof differs from the pinned one")
            log(f"{key}: one card {singles[key]:.1f} ms (warm, trace built "
                "before), peak "
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
            jobs.append(_job(key, path, trace_path, expected,
                             f"{count} tx depth {TX_DEPTH}, {what}"))
        del trace
    del ex, big, base
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results = _launch_nccl(jobs)
    launches = _report_sharded(jobs, results, "nccl", singles)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"sharded": {
        name: dict(launches=launches[name], single_card_ms=singles[name],
                   wall_ms=[r[name]["wall_ms"] for r in results],
                   instrumented_ms=[r[name]["timed_ms"] for r in results],
                   collective_ms=[sum(s["ms"] for s in r[name]["stats"]
                                      .values()) for r in results],
                   setup_ms=[r[name]["setup_ms"] for r in results],
                   peak_mib=[r[name]["peak"] / 2**20 for r in results])
        for name in singles}}))
    for line in cards:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    import certificate_stark_tpu_torch  # noqa: F401 - fails without the port
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    mode = sys.argv[1:]
    witness = start_witness() if mode in ([], ["--tx1024"], ["--parallel"]) \
        else None
    try:
        return run(dev, mode, t_start, witness)
    finally:
        if witness is not None and witness[0].is_alive():
            witness[0].terminate()
            witness[0].join()


def run(dev, mode, t_start, witness):
    phase_versions()
    probe = phase_build()
    sass = phase_sass()
    latency_ns = phase_latency(probe, dev)
    if mode == ["--trace"]:
        # the trace kernel's checks and measurements alone, for comparing
        # checkouts
        row = phase_trace_kernel(dev, None, latency_ns)
        row["ms_by_size"] = phase_trace_sizes(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(trace=row)))
        print(card_line())
        return 0
    if mode == ["--trees"]:
        # the tree kernels' checks and measurements alone
        rows = phase_trees(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(trees=rows)))
        print(card_line())
        return 0
    if mode[:1] == ["--hashes"]:
        # the leaf and merge kernels' checks and measurements alone
        rows = phase_hashes(dev, tuple(mode[1:]) or tuple(HASH_CHECKS))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(hashes=rows)))
        print(card_line())
        return 0
    if mode == ["--rescue"]:
        # the Rescue kernel's measurements alone, for comparing checkouts
        row = phase_rescue(dev, _randoms(dev))
        prof = phase_profile(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(rescue=row, sass=sass, profile=prof)))
        print(card_line())
        return 0
    if mode == ["--parallel"]:
        # the sharded prover on four cards over NCCL
        return run_parallel(dev, witness, t_start)
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.utils import curve as CV
    if mode == ["--sharded"]:
        # the default run's sharded phase alone (four ranks on this card)
        CV.set_curve("fp2")
        ex = TX.TransactionExample(TX_COUNT, ProofOptions(**BENCH_OPTS),
                                   depth=TX_DEPTH, device=dev)
        launches = phase_parallel(dev, ex)[0]
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(launches_by_path={"sharded4_tx128": launches})))
        print(card_line())
        return 0
    if mode == ["--ntt"]:
        # the ntt and lde kernels alone, at the transaction paths' shapes
        rows = phase_ntt(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(ntt=rows)))
        print(card_line())
        return 0
    if mode == ["--deep"]:
        # the proof's tail alone: ood, deep and fri_fold at the transaction
        # paths' shapes, and phase_ood, phase_deep and the FRI folds of the
        # 128- and 1024-transaction paths apart from the coin draws
        rows = phase_tail(dev)
        spans = phase_tail_paths(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(tail=rows, spans=spans)))
        print(card_line())
        return 0
    if mode == ["--eval"]:
        # the evaluation and composition kernels alone: the 128-transaction
        # AIR's tables with a random trace LDE
        CV.set_curve("fp2")
        air = TX.TransactionAir(TX_COUNT * TX.CYCLE, ([1] * 7, [2] * 7),
                                ProofOptions(**BENCH_OPTS), depth=TX_DEPTH)
        prover = Prover(air, device=dev)
        rows = phase_eval(dev, prover,
                          _randoms(dev)(TX.TRACE_WIDTH, prover.bn))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(eval=rows)))
        print(card_line())
        return 0
    if mode == ["--tx1024"]:
        # the 1024-transaction paths, their kernels' new shapes and the
        # chunked 128-transaction proof alone
        phase_hashes(dev, ("blake3",))
        CV.set_curve("fp2")
        ex = TX.TransactionExample(TX_COUNT, ProofOptions(**BENCH_OPTS),
                                   depth=TX_DEPTH, device=dev)
        raw = Prover(ex.air(), device=dev).prove(ex.trace).to_bytes()
        phase_chunked128(dev, ex, raw)
        launches = phase_tx1024(dev, witness, latency_ns)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(launches_by_path=launches)))
        print(card_line())
        return 0
    rows = phase_kernels(dev) + phase_hashes(dev) + phase_trees(dev)
    phase_ext(dev)
    grind_launches = phase_grind(dev)
    phase_golden16(dev)
    chain_launches, chain_ex, chain_proof = phase_full(dev)
    phase_verify(chain_ex, chain_proof.to_bytes(), "chain 1024")
    phase_profile(dev)
    phase_scale(dev)
    phase_tx_goldens(dev)
    phase_checkpoint(dev)
    t0 = time.perf_counter()
    ex = TX.TransactionExample(TX_COUNT, ProofOptions(**BENCH_OPTS),
                               depth=TX_DEPTH, device=dev)
    log(f"witness, {TX_COUNT} tx depth {TX_DEPTH} (host Python): "
        f"{time.perf_counter() - t0:.1f} s")
    rows.append(phase_trace_kernel(dev, ex, latency_ns))
    prover, raw, tx_launches = phase_tx_full(dev, ex)
    _lde_peaks(prover, ex.trace)
    lde = phase_tx_profile(dev, ex, prover)
    rows += phase_eval(dev, prover, lde)
    del lde
    plain_trace = phase_tx_plain(dev, ex, raw)
    phase_chunked128(dev, ex, raw)
    phase_verify(ex, raw, f"{TX_COUNT} tx, bench options")
    sharded_launches, sharded_shapes = phase_parallel(dev, ex)
    # the example CLI's defaults on the same witness
    cli = copy.copy(ex)
    cli.options = ProofOptions(**CLI_OPTS)
    what = "cubic, BLAKE3 (the example CLI's defaults)"
    cli_prover, cli_raw, cli_launches = phase_tx_full(dev, cli, what)
    profile_tx_proof(cli, cli_prover, f"{TX_COUNT} tx, {what}")
    phase_verify(cli, cli_raw, f"{TX_COUNT} tx, {what}")
    phase_tx_plain(dev, cli, cli_raw, what, plain_trace)
    del prover, cli_prover   # each path's peak memory holds its own Prover
    sha_launches = phase_sha_paths(dev, ex, plain_trace)
    del plain_trace
    phase_subair_goldens(dev)
    sub_launches, sub_trace_ms = phase_subairs(dev)
    tx1024_launches = phase_tx1024(dev, witness, latency_ns)
    rows += phase_ntt(dev, {
        "ntt": K.ntt.shapes | sharded_shapes["ntt"],
        "lde": K.lde.shapes | sharded_shapes["lde"]})
    rows += phase_tail(dev, {
        "ood": K.ood.shapes | sharded_shapes["ood"],
        "deep": K.deep.shapes | sharded_shapes["deep"],
        "fri_fold": K.fri_fold.shapes | sharded_shapes["fri_fold"]})
    paths = {"chain1024": chain_launches, "tx128": tx_launches,
             "tx128_cubic": cli_launches, **sha_launches, **sub_launches,
             **tx1024_launches, **grind_launches,
             "sharded4_tx128": sharded_launches}
    for row in rows:
        path = ROW_PATHS.get(row["name"]) or (
            "tx128_sha256" if row["name"].startswith("sha256")
            else "tx128_sha3_cubic" if row["name"].startswith("sha3")
            else "tx128_cubic")
        row["launches"] = paths[path][row["name"]]
        row["path"] = path
        row["launches_by_path"] = {p: n[row["name"]] for p, n in paths.items()}
        if row["name"] == "transaction_trace":
            row["ms_by_path"] = sub_trace_ms
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
