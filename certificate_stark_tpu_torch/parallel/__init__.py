"""The prover sharded over D ranks with torch.distributed: one process a
rank, one device a rank.

Counterpart of certificate_stark_tpu/parallel/: `mesh` (the ranks, their
devices, the collectives and a launcher that spawns them), `ntt` (the
six-step NTT whose transposes are all-to-alls), `merkle` (a Merkle tree
whose leaves are split over the ranks) and `prover` (`ShardedProver`,
whose proofs are the single-device prover's bytes).
"""
