"""State-transition example CLI of the port: the twin of the JAX package's
examples/state_transition.py (the reference's examples/state-transition.rs
flags), proving on the GPU and verifying with the port's verifier.

    python -m certificate_stark_tpu_torch.examples.state_transition -n 128
    python -m certificate_stark_tpu_torch.examples.state_transition -n 128 \\
        --hash-fn sha3
    python -m certificate_stark_tpu_torch.examples.state_transition \\
        -n 2 --depth 3 --device cpu

Flags: -n/--num-transactions, -q/--queries, -b/--blowup, -g/--grinding,
--hash-fn (rescue, sha256, blake3 or sha3, each with its kernels),
-e/--extension (1, 2, 3), -f/--fri-folding, --depth (the reference fixes
15), -v/--verbose (per-phase prover spans, the domain segments and, on the
card, the peak device memory), --device (default cuda). `-n 1024` is the
JAX package's north star: a 94 x 2^20 trace over an LDE of 2^23 points,
proved in segments of 2^20 points (engine/prover.py EVAL_CHUNK).
Prints the witness time, the proof time, size and security, and the
verification time, like the JAX package's CLI.
"""
import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="Topos state-transition STARK "
                                 "(PyTorch/CUDA port)")
    ap.add_argument("-n", "--num-transactions", type=int, default=4)
    ap.add_argument("-q", "--queries", type=int, default=42)
    ap.add_argument("-b", "--blowup", type=int, default=8)
    ap.add_argument("-g", "--grinding", type=int, default=0)
    # the reference example's defaults: BLAKE3 commitments, the cubic
    # extension field
    ap.add_argument("--hash-fn", default="blake3",
                    choices=["rescue", "sha256", "blake3", "sha3"])
    ap.add_argument("-e", "--extension", type=int, default=3,
                    choices=[1, 2, 3])
    ap.add_argument("-f", "--fri-folding", type=int, default=4,
                    choices=[2, 4])
    ap.add_argument("--depth", type=int, default=15)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-phase prover spans, segments, peak memory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to prove on (default: cuda)")
    args = ap.parse_args(argv)

    from ..engine.options import ProofOptions
    from ..engine.prover import Prover
    from ..models.transaction import TransactionExample

    opts = ProofOptions(num_queries=args.queries, blowup=args.blowup,
                        grinding_bits=args.grinding, hash_fn=args.hash_fn,
                        extension_degree=args.extension,
                        fri_folding=args.fri_folding)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    ex = TransactionExample(args.num_transactions, opts, depth=args.depth,
                            device=dev)
    print(f"witness + trace built in {time.time() - t0:.2f} s "
          f"({args.num_transactions} txs, depth {args.depth})")

    spans = []
    t_last = [0.0]

    def mark(label):
        sync()
        now = time.time()
        spans.append((label, now - t_last[0]))
        t_last[0] = now

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = t_last[0] = time.time()
    prover = Prover(ex.air(), ex.device)
    proof = prover.prove(ex.trace, mark=mark if args.verbose else None)
    sync()
    print(f"proof generated in {time.time() - t0:.2f} s")
    for label, s in spans:
        print(f"  {label:32s} {s * 1e3:10.1f} ms")
    if args.verbose:
        print(f"  LDE domain {prover.bn} points in segments of "
              f"{prover.chunk}")
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev) / 2**20
            print(f"  peak device memory {peak:.0f} MiB")
    print(f"proof size: {proof.size_bytes() / 1024:.1f} KB")
    print(f"proof security: {proof.security_level()} bits")

    t0 = time.time()
    assert ex.verify(proof)
    print(f"proof verified in {time.time() - t0:.2f} s")


if __name__ == "__main__":
    main()
