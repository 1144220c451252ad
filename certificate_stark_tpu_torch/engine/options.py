"""Proof options, a copy of certificate_stark_tpu/engine/options.py — mirrors
the reference's 7-arg `ProofOptions::new(queries, blowup, grinding, hash,
extension, fri_folding, fri_max_remainder)` (src/lib.rs:78-86; defaults 42,
8, 0, Blake3, None, 4, 256). The port commits with every hash_fn of the JAX
package ("rescue", "sha256", "blake3", "sha3"; engine/hasher.py) over the
base field or its quadratic or cubic extension."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProofOptions:
    num_queries: int = 42
    blowup: int = 8
    grinding_bits: int = 0
    hash_fn: str = "rescue"  # "rescue" (algebraic, default), "sha256", "blake3", "sha3"
    extension_degree: int = 1      # 1 = none, 2 = quadratic, 3 = cubic
    fri_folding: int = 4
    fri_max_remainder: int = 256

    def __post_init__(self):
        assert self.blowup & (self.blowup - 1) == 0 and self.blowup >= 2
        assert self.fri_folding in (2, 4)
        assert self.extension_degree in (1, 2, 3)

    def context_elements(self, trace_width: int, trace_length: int) -> list:
        """Elements absorbed into the Fiat-Shamir seed (protocol context)."""
        return [trace_width, trace_length, self.num_queries, self.blowup,
                self.grinding_bits, self.extension_degree, self.fri_folding,
                self.fri_max_remainder,
                {"rescue": 0, "sha256": 1, "blake3": 2,
                 "sha3": 3}[self.hash_fn]]
