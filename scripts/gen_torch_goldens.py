#!/usr/bin/env python
"""Generate the full-size golden that the PyTorch port is held to on the GPU
(tests/vectors/torch_goldens.json).

The JAX package proves the rescue hash chain of length 1024 (trace 14 x 8192,
blowup 4, 42 queries, Rescue commitments, FRI fold 4 / remainder 256: the
`bench.py` `_bench_rescue_chain` options with hash_fn="rescue") on the CPU,
verifies it, and records the proof's SHA-256, its length and the coin journal.
`chip_smoke.py` proves the same statement with the port on the card and
compares. Run once, with JAX on the CPU:

    env JAX_PLATFORMS=cpu python scripts/gen_torch_goldens.py
"""
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from certificate_stark_tpu.engine import prover as PR  # noqa: E402
from certificate_stark_tpu.engine.options import ProofOptions  # noqa: E402
from certificate_stark_tpu.models import rescue_chain as RC  # noqa: E402

CHAIN = 1024


def main():
    opts = ProofOptions(num_queries=42, blowup=4, grinding_bits=0,
                        hash_fn="rescue", extension_degree=1,
                        fri_folding=4, fri_max_remainder=256)
    t0 = time.time()
    ex = RC.RescueChainExample(CHAIN, opts)
    air = RC.RescueChainAir(CHAIN * 8, ex.pub_inputs(), opts)
    p = PR.Prover(air)
    p.coin_journal = []
    proof = p.prove(ex.trace)
    prove_s = time.time() - t0
    assert ex.verify(proof)
    raw = proof.to_bytes()
    out = {
        f"rescue_chain{CHAIN}_rescue": {
            "chain_length": CHAIN,
            "options": {"num_queries": 42, "blowup": 4, "grinding_bits": 0,
                        "hash_fn": "rescue", "extension_degree": 1,
                        "fri_folding": 4, "fri_max_remainder": 256},
            "seed": ex.seed,
            "result": ex.result,
            "journal": [[kind, val] for kind, val in p.coin_journal],
            "proof_sha256": hashlib.sha256(raw).hexdigest(),
            "proof_len": len(raw),
            "generated_by": "scripts/gen_torch_goldens.py (JAX package, CPU)",
            "cpu_seconds": round(time.time() - t0, 1),
            "cpu_prove_seconds": round(prove_s, 1),
        }
    }
    path = os.path.join(ROOT, "tests", "vectors", "torch_goldens.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print("wrote", path, "in", round(time.time() - t0, 1), "s")


if __name__ == "__main__":
    main()
