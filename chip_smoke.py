#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from certificate_stark_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, reproduces the committed
goldens (rescue chain 16 from tests/vectors/transcripts.json, rescue chain
1024 from tests/vectors/torch_goldens.json), times the chain-1024 proof by
phase, and proves chain 8192 once with the kernels and once with the plain
versions, which must give the same bytes. Any mismatch raises. Prints a
`kernels` JSON line, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when there is
no CUDA device or no port beside it.
"""
import hashlib
import json
import os
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
# 32-bit multiplies in one Montgomery multiply: 8 for the 64x64->128 product
# (four partial products, low and high halves), 4 for m = t*N' mod 2^64; the
# m*p term of REDC is shifts and adds (p is sparse)
MULS_PER_MMUL = 12
# Montgomery multiplies in one Rescue permutation: 7 rounds x (14 * 2 s-box
# + 2 * 196 MDS + 14 * (61 + 32) inverse s-box)
MMUL_PER_PERM = 7 * (14 * 2 + 2 * 196 + 14 * (61 + 32))


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


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


def bound_ms(nbytes, muls):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_versions():
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    from certificate_stark_tpu_torch.ops import kernels as K
    out = subprocess.run([K._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log("nvcc", out[-1])


def phase_build():
    from certificate_stark_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    paths = K.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        for line in open(path + ".log").read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(dev):
    """Each kernel against its plain version on the card, bit for bit."""
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.ops import field as F, rescue as R
    P = F.P
    g = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=g, device=dev,
                             dtype=torch.int64)

    rows = []
    # f63_mul: 2^24 random values plus the edge values, then the main
    # path's largest product (the MDS layer of the chain-1024 constraint
    # evaluation, [14, 14, 2^15])
    edge = torch.tensor([0, 1, P - 1, P - 2, 1 << 32, (1 << 63) % P],
                        dtype=torch.int64, device=dev)
    a = torch.cat([rand(1 << 24), edge.repeat_interleave(6)])
    b = torch.cat([rand(1 << 24), edge.repeat(6)])
    got, exp = K.f63_mul(a, b), K.mul_plain(a, b)
    err = int((got - exp).abs().max())
    check(err == 0, "f63_mul differs from its plain version at 2^24")
    n = 14 * 14 * (1 << 15)
    a, b = rand(n), rand(n)
    got, exp = K.f63_mul(a, b), K.mul_plain(a, b)
    err = max(err, int((got - exp).abs().max()))
    check(err == 0, "f63_mul differs from its plain version at 14x14x2^15")
    ms = cuda_ms(lambda: K.f63_mul(a, b), 50)
    plain = cuda_ms(lambda: K.mul_plain(a, b), 5)
    bnd, by = bound_ms(24 * n, n * MULS_PER_MMUL)
    rows.append(dict(name="f63_mul", route="cuda",
                     source="certificate_stark_tpu_torch/csrc/f63_mul.cu",
                     replaces="certificate_stark_tpu/ops/pallas_kernels.py:177",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                     bound_by=by, library_ms=None, shape=[n]))
    log(f"f63_mul [{n}]: {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} "
        f"ms ({by})")

    # rescue_permutation: [14, 2^16] random states, then the main path's
    # leaf-hashing batch [14, 2^15]
    mds, _, ark = R.tables(dev)
    err = 0
    for nstates in (1 << 16, 1 << 15):
        st = rand(14, nstates)
        got = K.rescue_permutation(st, mds, ark)
        exp = K.rescue_permutation_plain(st, mds, ark)
        err = max(err, int((got - exp).abs().max()))
        check(err == 0, f"rescue_permutation differs at [14, {nstates}]")
        ms = cuda_ms(lambda: K.rescue_permutation(st, mds, ark), 20)
        log(f"rescue_permutation [14, {nstates}]: {ms:.4f} ms")
    plain = cuda_ms(lambda: K.rescue_permutation_plain(st, mds, ark), 2)
    bnd, by = bound_ms(2 * 14 * 8 * nstates, nstates * MMUL_PER_PERM
                       * MULS_PER_MMUL)
    rows.append(dict(name="rescue_permutation", route="cuda",
                     source="certificate_stark_tpu_torch/csrc/rescue_perm.cu",
                     replaces="certificate_stark_tpu/ops/pallas_kernels.py:143",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                     bound_by=by, library_ms=None, shape=[14, nstates]))
    log(f"rescue_permutation [14, {nstates}]: plain {plain:.4f} ms, bound "
        f"{bnd:.4f} ms ({by})")
    return rows


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
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    with open(os.path.join(ROOT, "tests", "vectors", "transcripts.json")) as f:
        golden = json.load(f)["rescue_chain16_rescue"]
    opts = ProofOptions(num_queries=14, blowup=4, hash_fn="rescue")
    _golden_check("rescue_chain16_rescue", golden, *_prove(16, opts, dev))


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
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    _golden_check("rescue_chain1024_rescue", golden, prover, proof)
    return launches


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


def main():
    import certificate_stark_tpu_torch  # noqa: F401 - fails without the port
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_versions()
    phase_build()
    rows = phase_kernels(dev)
    phase_golden16(dev)
    launches = phase_full(dev)
    phase_scale(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
