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
# 32-bit multiplies (the low or the high half of one 32x32 product) in the
# least work known for each function. A Montgomery multiply: 8 for the four
# partial products of the 64x64->128 product, 4 for the two word-level REDC
# steps (m*k, low and high half; p = k*2^32 + 1). A squaring has three
# partial products. An MDS row sums 14 unreduced products and reduces once.
MULS_PER_MMUL = 12
MULS_PER_MSQR = 10
MULS_PER_MDS_ROW = 14 * 8 + 4
# the inverse s-box chain of ops/kernels.py INV_ALPHA_CHAIN
INV_ALPHA_SQR, INV_ALPHA_MUL = 61, 12
# one Rescue permutation: 7 rounds x 14 lanes x (s-box x^3: a squaring and a
# multiply; two MDS rows; the inverse s-box chain)
MULS_PER_PERM = 7 * 14 * (MULS_PER_MSQR + MULS_PER_MMUL + 2 * MULS_PER_MDS_ROW
                          + INV_ALPHA_SQR * MULS_PER_MSQR
                          + INV_ALPHA_MUL * MULS_PER_MMUL)
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


def phase_sass():
    """Static SASS instruction counts of every kernel, and the Rescue
    kernels' instructions per permutation (per thread x threads a state)."""
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
    phase_versions()
    phase_build()
    sass = phase_sass()
    if sys.argv[1:] == ["--rescue"]:
        # the Rescue kernel's measurements alone, for comparing checkouts
        row = phase_rescue(dev, _randoms(dev))
        prof = phase_profile(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(dict(rescue=row, sass=sass, profile=prof)))
        print(card_line())
        return 0
    rows = phase_kernels(dev)
    phase_golden16(dev)
    launches = phase_full(dev)
    phase_profile(dev)
    phase_scale(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
