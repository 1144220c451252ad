"""PyTorch/CUDA port of certificate_stark_tpu: the same STARK prover over the
63-bit field p = 2^62 + 2^56 + 2^55 + 1, with hand-written Hopper kernels in
place of the JAX package's Pallas kernels. Imports torch and numpy only."""
