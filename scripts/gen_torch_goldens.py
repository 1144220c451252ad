#!/usr/bin/env python
"""Generate the goldens that the PyTorch port is held to
(tests/vectors/torch_goldens.json).

The JAX package proves each statement on the CPU, its verifier accepts the
proof, and the proof's SHA-256, its length and the coin journal are recorded
(for the transaction goldens also the trace's SHA-256 and the public roots).
`chip_smoke.py` proves the same statements with the port on the card and
compares; the CPU tests compare the two-transaction ones.

  rescue_chain1024_rescue      rescue hash chain 1024 (trace 14 x 8192),
                               bench.py `_bench_rescue_chain` options with
                               Rescue commitments
  transaction_2tx_d3_rescue    composed state-transition AIR, 2 transactions,
                               depth 3, the options and seed of
                               tests/test_transaction.py
  transaction_2tx_d3_blake3    the same with BLAKE3 commitments
  transaction_16tx_d15_blake3  bench.py `_bench_transaction` options at its
                               CPU-fallback size (16 transactions, depth 15,
                               seed 42): the batched witness path
  rescue_chain16_quadratic_rescue_grind11
                               rescue hash chain 16, quadratic extension,
                               Rescue commitments, 11 bits of grinding (the
                               batched nonce search)
  transaction_2tx_d3_cubic_blake3
                               transaction_2tx_d3_blake3 over the cubic
                               extension (the example CLI's default field)
  transaction_16tx_d15_cubic_blake3_grind12
                               transaction_16tx_d15_blake3 over the cubic
                               extension with 12 bits of grinding
  range_64bit_rescue           range proof of 123456789123456789 with the
                               options of tests/test_range.py (14 queries,
                               blowup 8, Rescue commitments)
  merkle_init_rescue           the merkle-init example (all-zero inputs,
                               delta 1), the same options
  merkle_update_1tx_d3_blake3  merkle-update AIR, 1 transaction at depth 3,
                               seed 1, 14 queries, blowup 8, BLAKE3
  merkle_update_16tx_d15_blake3
                               merkle-update AIR, 16 transactions at depth
                               15, seed 1, the bench options
  schnorr_2sig_blake3          Schnorr AIR, 2 signatures, seed 5, 14
                               queries, blowup 8, BLAKE3
  schnorr_16sig_blake3         Schnorr AIR, 16 signatures, seed 5, the bench
                               options
  rescue_chain16_sha256        rescue hash chain 16, 8 queries, blowup 4
  rescue_chain16_sha3          (the options of tests/test_sha3.py), with
                               SHA-256 or SHA3-256 commitments
  rescue_chain16_sha256_grind12
                               rescue_chain16_sha256 with 12 bits of
                               grinding (the batched SHA-256 nonce search)
  transaction_2tx_d3_sha256    transaction_2tx_d3_blake3 with SHA-256 or
  transaction_2tx_d3_sha3      SHA3-256 commitments
  transaction_16tx_d15_sha3    transaction_16tx_d15_blake3 with SHA3-256
                               commitments

The transaction and Schnorr goldens use the fp2 curve instance (the library default).
Run with JAX on the CPU; names select goldens (default: all), and the file
keeps the entries not regenerated:

    env JAX_PLATFORMS=cpu python scripts/gen_torch_goldens.py [name ...]
"""
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from certificate_stark_tpu.engine import prover as PR  # noqa: E402
from certificate_stark_tpu.engine.options import ProofOptions  # noqa: E402
from certificate_stark_tpu.ops import field as F  # noqa: E402
from certificate_stark_tpu.utils import curve as CV  # noqa: E402

PATH = os.path.join(ROOT, "tests", "vectors", "torch_goldens.json")
CHAIN = 1024
TX_TEST_OPTS = dict(num_queries=14, blowup=8, grinding_bits=0,
                    hash_fn="rescue", extension_degree=1, fri_folding=4,
                    fri_max_remainder=256)
BENCH_OPTS = dict(num_queries=42, blowup=8, grinding_bits=0,
                  hash_fn="blake3", extension_degree=1, fri_folding=4,
                  fri_max_remainder=256)


def _record(opts_dict, prover, proof, t0, prove_s):
    raw = proof.to_bytes()
    return {
        "options": opts_dict,
        "journal": [[kind, val] for kind, val in prover.coin_journal],
        "proof_sha256": hashlib.sha256(raw).hexdigest(),
        "proof_len": len(raw),
        "generated_by": "scripts/gen_torch_goldens.py (JAX package, CPU)",
        "cpu_seconds": round(time.time() - t0, 1),
        "cpu_prove_seconds": round(prove_s, 1),
    }


def chain_golden(chain, od):
    from certificate_stark_tpu.models import rescue_chain as RC
    opts = ProofOptions(**od)
    t0 = time.time()
    ex = RC.RescueChainExample(chain, opts)
    air = RC.RescueChainAir(chain * 8, ex.pub_inputs(), opts)
    p = PR.Prover(air)
    p.coin_journal = []
    proof = p.prove(ex.trace)
    prove_s = time.time() - t0
    assert ex.verify(proof)
    out = _record(od, p, proof, t0, prove_s)
    out.update(chain_length=chain, seed=ex.seed, result=ex.result)
    return out


def transaction_golden(n_tx, depth, seed, od):
    from certificate_stark_tpu.models import transaction as TX
    CV.set_curve("fp2")
    opts = ProofOptions(**od)
    t0 = time.time()
    ex = TX.TransactionExample(n_tx, opts, depth=depth, seed=seed)
    witness_s = time.time() - t0
    trace = TX.build_trace(ex.md, ex.messages)
    words = np.ascontiguousarray(F.pack_u64(np.asarray(trace)))  # [94, n]
    air = TX.TransactionAir(1024 * n_tx, ex.pub_inputs(), opts, depth=depth)
    p = PR.Prover(air)
    p.coin_journal = []
    t1 = time.time()
    proof = p.prove(trace)
    prove_s = time.time() - t1
    assert ex.verify(proof)
    out = _record(od, p, proof, t0, prove_s)
    out.update(num_transactions=n_tx, depth=depth, seed=seed, curve="fp2",
               initial_root=[int(v) for v in ex.pub_inputs()[0]],
               final_root=[int(v) for v in ex.pub_inputs()[1]],
               trace_sha256=hashlib.sha256(
                   words.astype("<u8").tobytes()).hexdigest(),
               cpu_witness_seconds=round(witness_s, 1))
    return out


def _trace_sha256(trace):
    words = np.ascontiguousarray(F.pack_u64(np.asarray(trace)))  # [w, n]
    return hashlib.sha256(words.astype("<u8").tobytes()).hexdigest()


def _example_golden(ex, air, od, t0, witness_s, verify_kw=None):
    """Prove `air` for the example's trace, verify with the example's own
    verifier, and record the proof with the trace's SHA-256."""
    p = PR.Prover(air)
    p.coin_journal = []
    t1 = time.time()
    proof = p.prove(ex.trace)
    prove_s = time.time() - t1
    assert ex.verify(proof)
    out = _record(od, p, proof, t0, prove_s)
    out.update(trace_sha256=_trace_sha256(ex.trace),
               cpu_witness_seconds=round(witness_s, 1))
    return out


def range_golden(number, od):
    from certificate_stark_tpu.models import range as RG
    opts = ProofOptions(**od)
    t0 = time.time()
    ex = RG.RangeExample(number, opts)
    out = _example_golden(ex, RG.RangeAir(RG.RANGE_LOG, [number], opts), od,
                          t0, time.time() - t0)
    out.update(number=number)
    return out


def merkle_init_golden(od):
    from certificate_stark_tpu.models import merkle_init as MI
    opts = ProofOptions(**od)
    t0 = time.time()
    ex = MI.MerkleInitExample(opts)
    return _example_golden(
        ex, MI.MerkleInitAir(MI.CYCLE, ex.pub_inputs(), opts), od, t0,
        time.time() - t0)


def merkle_update_golden(n_tx, depth, seed, od):
    from certificate_stark_tpu.models import merkle_update as MU
    opts = ProofOptions(**od)
    t0 = time.time()
    ex = MU.MerkleUpdateExample(n_tx, opts, depth=depth, seed=seed)
    witness_s = time.time() - t0
    air = MU.MerkleUpdateAir(MU.CYCLE * n_tx, ex.pub_inputs(), opts,
                             depth=depth)
    out = _example_golden(ex, air, od, t0, witness_s)
    out.update(num_transactions=n_tx, depth=depth, seed=seed,
               initial_root=[int(v) for v in ex.pub_inputs()[0]],
               final_root=[int(v) for v in ex.pub_inputs()[1]])
    return out


def schnorr_golden(n_sig, seed, od):
    from certificate_stark_tpu.models import schnorr as SC
    CV.set_curve("fp2")
    opts = ProofOptions(**od)
    t0 = time.time()
    ex = SC.SchnorrExample(n_sig, opts, seed=seed)
    witness_s = time.time() - t0
    air = SC.SchnorrAir(SC.SIG_CYCLE * n_sig, ex.pub_inputs(), opts)
    out = _example_golden(ex, air, od, t0, witness_s)
    out.update(num_signatures=n_sig, seed=seed, curve="fp2",
               s_values=[str(s) for _, s in ex.signatures])
    return out


GOLDENS = {
    f"rescue_chain{CHAIN}_rescue":
        lambda: chain_golden(CHAIN, dict(TX_TEST_OPTS, num_queries=42,
                                         blowup=4)),
    "transaction_2tx_d3_rescue":
        lambda: transaction_golden(2, 3, 3, TX_TEST_OPTS),
    "transaction_2tx_d3_blake3":
        lambda: transaction_golden(2, 3, 3, dict(TX_TEST_OPTS,
                                                 hash_fn="blake3")),
    "transaction_16tx_d15_blake3":
        lambda: transaction_golden(16, 15, 42, BENCH_OPTS),
    "rescue_chain16_quadratic_rescue_grind11":
        lambda: chain_golden(16, dict(TX_TEST_OPTS, blowup=4,
                                      extension_degree=2, grinding_bits=11)),
    "transaction_2tx_d3_cubic_blake3":
        lambda: transaction_golden(2, 3, 3, dict(TX_TEST_OPTS,
                                                 hash_fn="blake3",
                                                 extension_degree=3)),
    "transaction_16tx_d15_cubic_blake3_grind12":
        lambda: transaction_golden(16, 15, 42, dict(BENCH_OPTS,
                                                    extension_degree=3,
                                                    grinding_bits=12)),
    "range_64bit_rescue":
        lambda: range_golden(123456789123456789, TX_TEST_OPTS),
    "merkle_init_rescue":
        lambda: merkle_init_golden(TX_TEST_OPTS),
    "merkle_update_1tx_d3_blake3":
        lambda: merkle_update_golden(1, 3, 1, dict(TX_TEST_OPTS,
                                                   hash_fn="blake3")),
    "merkle_update_16tx_d15_blake3":
        lambda: merkle_update_golden(16, 15, 1, BENCH_OPTS),
    "schnorr_2sig_blake3":
        lambda: schnorr_golden(2, 5, dict(TX_TEST_OPTS, hash_fn="blake3")),
    "schnorr_16sig_blake3":
        lambda: schnorr_golden(16, 5, BENCH_OPTS),
    "rescue_chain16_sha256":
        lambda: chain_golden(16, dict(TX_TEST_OPTS, num_queries=8, blowup=4,
                                      hash_fn="sha256")),
    "rescue_chain16_sha3":
        lambda: chain_golden(16, dict(TX_TEST_OPTS, num_queries=8, blowup=4,
                                      hash_fn="sha3")),
    "rescue_chain16_sha256_grind12":
        lambda: chain_golden(16, dict(TX_TEST_OPTS, num_queries=8, blowup=4,
                                      hash_fn="sha256", grinding_bits=12)),
    "transaction_2tx_d3_sha256":
        lambda: transaction_golden(2, 3, 3, dict(TX_TEST_OPTS,
                                                 hash_fn="sha256")),
    "transaction_2tx_d3_sha3":
        lambda: transaction_golden(2, 3, 3, dict(TX_TEST_OPTS,
                                                 hash_fn="sha3")),
    "transaction_16tx_d15_sha3":
        lambda: transaction_golden(16, 15, 42, dict(BENCH_OPTS,
                                                    hash_fn="sha3")),
}


def main(names):
    names = names or list(GOLDENS)
    unknown = sorted(set(names) - set(GOLDENS))
    if unknown:
        raise SystemExit(f"unknown goldens {unknown}; choices {list(GOLDENS)}")
    goldens = {}
    if os.path.exists(PATH):
        with open(PATH) as f:
            goldens = json.load(f)
    for name in names:
        t0 = time.time()
        goldens[name] = GOLDENS[name]()
        with open(PATH, "w") as f:
            json.dump(goldens, f, indent=1, sort_keys=True)
        print("wrote", name, "to", PATH, "in", round(time.time() - t0, 1),
              "s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
