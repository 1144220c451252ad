"""Where csrc/air_eval.cu (`transaction_eval`) spends its time, on the card.

Builds an instrumented copy of the kernel: clock64 at each item's start and
end on each warp and at each block's start and end, and a schedule check
that takes any multiset of items, so that other warp schedules than
ops/kernels.py EVAL_WARPS can be timed (their slots are then wrong; only
the time is read). Then:

- the per-item cycles (medians over the first wave of blocks) and the
  block cycles over every block of a [115, 2^20] launch, under EVAL_WARPS;
- the ms of a launch (CUDA events) under EVAL_WARPS and under other
  schedules: the point formulas spread over more warps, and one item kind
  on every warp (how that item's cost grows when it fills the SM);
- throughput microbenchmarks of the kernel's arithmetic helpers at its
  occupancy (2 blocks of 256 threads an SM, 4 independent chains a
  thread): scheduler cycles an op.

    python3 scripts/profile_air_eval.py

Needs a CUDA card and nvcc; builds into build/profile_air_eval/. Ends with
the card's name and power limit.
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from certificate_stark_tpu_torch.engine.options import ProofOptions  # noqa
from certificate_stark_tpu_torch.models import transaction as TX  # noqa
from certificate_stark_tpu_torch.ops import kernels as K  # noqa
from certificate_stark_tpu_torch.utils import curve as CV  # noqa

OUT = os.path.join(ROOT, "build", "profile_air_eval")
S = 1 << 20
BLOCKS = S // 32
FIRST_WAVE = 264          # 2 blocks on each of 132 SMs
REPS = 5


def instrumented_source():
    src = open(os.path.join(K.CSRC, "air_eval.cu")).read()
    edits = [
        ("            if (ended || kind >= K_KINDS || param >= count[kind] ||\n"
         "                seen[kind][param]++)",
         "            if (ended || kind >= K_KINDS || param >= count[kind])"),
        ("            if (!seen[kind][param]) return -1;", "            ;"),
        ("    extern __shared__ u64 sm[];",
         "    extern __shared__ u64 sm[];\n    const long long tk0 = clock64();"),
        ("        int start = 0, n = 0;",
         "        const long long ti0 = clock64();\n"
         "        int start = 0, n = 0;"),
        ("        if (n) run_ec(start, n, x);\n    }\n    __syncthreads();",
         "        if (n) run_ec(start, n, x);\n"
         "        if (lane == 0) {\n"
         "            long long* c = PROF + ((blockIdx.x * WARPS + w) * ITEMS"
         " + k) * 2;\n"
         "            c[0] = ti0;\n            c[1] = clock64();\n        }\n"
         "    }\n    __syncthreads();"),
        ("        if (q < S) out[(k / TP) * S + q] = acc[k];\n    }\n}",
         "        if (q < S) out[(k / TP) * S + q] = acc[k];\n    }\n"
         "    if (tid == 0) {\n"
         "        long long* b = PROF + NPROF_ITEMS + blockIdx.x * 2;\n"
         "        b[0] = tk0;\n        b[1] = clock64();\n    }\n}"),
        ("struct Sched {",
         f"#define NPROF_ITEMS ({BLOCKS} * WARPS * ITEMS * 2)\n"
         f"__device__ long long PROF[NPROF_ITEMS + {BLOCKS} * 2];\n"
         "struct Sched {"),
    ]
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"profile_air_eval: the kernel source changed; "
                             f"no match for {old[:50]!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int prof_read(long long* h) {\n'
                  '    return (int)cudaMemcpyFromSymbol(h, PROF, '
                  'sizeof(PROF));\n}\n')


MICRO = r"""
#define CH 4
#define ITER 256
__device__ u64 micro_sink[1 << 16];
template <int OP>
__global__ void __launch_bounds__(256, 2) micro(const u64* in, long long* cyc) {
    __shared__ u64 shm[64 * 32];
    const int tid = threadIdx.x, lane = tid & 31;
    for (int k = tid; k < 64 * 32; k += 256) shm[k] = in[k] % F63_P;
    __syncthreads();
    u64 a[CH], b[CH];
    for (int c = 0; c < CH; c++) {
        a[c] = in[tid * 8 + c] % F63_P;
        b[c] = in[tid * 8 + 4 + c] % F63_P;
    }
    const long long t0 = clock64();
#pragma unroll 1
    for (int it = 0; it < ITER; it++) {
#pragma unroll
        for (int c = 0; c < CH; c++) {
            if (OP == 0) a[c] = f63_mmul(a[c], b[c]);
            if (OP == 1) a[c] = madd(a[c], b[c]);
            if (OP == 2) a[c] = msub(a[c], b[c]);
            if (OP == 3) a[c] = f63_add(a[c], b[c]);
            if (OP == 4) {
                u64 x, y;
                f2mul(a[c], b[c], b[c], a[c], x, y);
                a[c] = x;
                b[c] = y;
            }
            if (OP == 5) {
                u64 s[14];
                for (int j = 0; j < 14; j++) s[j] = shm[j * 32 + lane] ^ a[c];
                a[c] = mds_row(shm + 62 * 32 + 2 * c, s);
            }
            if (OP == 6) a[c] = shm[(int)(a[c] & 63) * 32 + lane] ^ b[c];
            if (OP == 7) {
                acc_add(shm + (c * 8 + (tid >> 5)) * 32 + lane, a[c]);
                a[c] ^= b[c];
            }
        }
    }
    const long long t1 = clock64();
    u64 r = 0;
    for (int c = 0; c < CH; c++) r ^= a[c] ^ b[c];
    micro_sink[(blockIdx.x * 256 + tid) & 0xffff] = r;
    if (tid == 0) cyc[blockIdx.x] = t1 - t0;
}
extern "C" int micro_run(int op, const void* in, long long* cyc, int blocks) {
    switch (op) {
        case 0: micro<0><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 1: micro<1><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 2: micro<2><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 3: micro<3><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 4: micro<4><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 5: micro<5><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 6: micro<6><<<blocks, 256>>>((const u64*)in, cyc); break;
        case 7: micro<7><<<blocks, 256>>>((const u64*)in, cyc); break;
    }
    return (int)cudaGetLastError();
}
"""
MICRO_OPS = ("f63_mmul", "madd", "msub", "f63_add (f63.cuh)",
             "f2mul", "mds_row (with 14 LDS)", "LDS.64", "acc_add (CAS)")


def build():
    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(K.CSRC, "f63.cuh"), OUT)
    src = instrumented_source()
    paths = {}
    for name, text in (("prof", src), ("micro", src + MICRO)):
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        paths[name] = os.path.join(OUT, f"lib{name}.so")
        r = subprocess.run([K._nvcc()] + K.NVCC_FLAGS + ["-o", paths[name], cu],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
        use = re.findall(r"Used \d+ registers.*|\d+ bytes stack frame.*",
                         r.stdout + r.stderr)
        print(f"build {name}: {'; '.join(use[:2])}")
    return paths


def table(warps):
    vals = []
    for reg, ranges in K.EVAL_ROUNDS:
        vals += [reg] + [v for r in ranges for v in r] + \
            [-1, 0] * (2 - len(ranges))
    for items in warps:
        vals += [K.EVAL_KINDS.index(kind) << 3 | p for kind, p in items] + \
            [-1] * (K.EVAL_ITEMS - len(items))
    return (ctypes.c_int * len(vals))(*vals)


def main():
    if not torch.cuda.is_available():
        print("profile_air_eval: no CUDA device", file=sys.stderr)
        return 1
    paths = build()
    lib = ctypes.CDLL(paths["prof"])
    lib.transaction_eval_launch.argtypes = \
        K._ENTRY_POINTS["air_eval"]["transaction_eval_launch"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rand(*shape):
        return torch.randint(0, K.P, shape, generator=g, device=dev,
                             dtype=torch.int64)
    cur, nxt, per = rand(94, S + 64)[:, 64:], rand(94, S), rand(48, S)
    CV.set_curve("fp2")
    air = TX.TransactionAir(128 * TX.CYCLE, ([1] * 7, [2] * 7),
                            ProofOptions(num_queries=42, blowup=8,
                                         hash_fn="blake3"), depth=15)
    consts = air.eval_consts(dev)
    out = torch.empty((115, S), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(sched):
        rc = lib.transaction_eval_launch(
            cur.data_ptr(), cur.stride(0), nxt.data_ptr(), S, per.data_ptr(),
            S, *[consts[n].data_ptr() for n, _ in K.TX_CONSTS], S,
            out.data_ptr(), sched, len(sched), stream)
        if rc:
            raise SystemExit(f"launch failed: cudaError {rc}")

    def ms(sched):
        launch(sched)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            launch(sched)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    # the default schedule: per-item and per-block cycles
    default = table(K.EVAL_WARPS)
    launch(default)
    torch.cuda.synchronize()
    n_items = BLOCKS * 8 * K.EVAL_ITEMS * 2
    h = (ctypes.c_longlong * (n_items + BLOCKS * 2))()
    if lib.prof_read(h):
        raise SystemExit("prof_read failed")
    h = list(h)
    first = collections.defaultdict(list)
    for b in range(FIRST_WAVE):
        t0 = h[n_items + 2 * b]
        for w, items in enumerate(K.EVAL_WARPS):
            for k, item in enumerate(items):
                i = ((b * 8 + w) * K.EVAL_ITEMS + k) * 2
                first[w, item].append((h[i] - t0, h[i + 1] - h[i]))
    print("EVAL_WARPS, first wave (2 blocks an SM): warp, item, median start "
          "and cycles from the block's start")
    for (w, item), v in first.items():
        print(f"  warp {w} {item[0]} {item[1]}: start "
              f"{statistics.median(x[0] for x in v):.0f}, cycles "
              f"{statistics.median(x[1] for x in v):.0f}")
    blocks = sorted(h[n_items + 2 * b + 1] - h[n_items + 2 * b]
                    for b in range(BLOCKS))
    print(f"EVAL_WARPS, every block of the launch: cycles p10 "
          f"{blocks[BLOCKS // 10]}, p50 {blocks[BLOCKS // 2]}, p90 "
          f"{blocks[9 * BLOCKS // 10]}, mean {statistics.mean(blocks):.0f}")

    r = lambda i: ("round", i)  # noqa: E731
    d = lambda i: ("double", i)  # noqa: E731
    m = lambda i: ("mixed", i)  # noqa: E731
    F, ME, H, RA, O = (("full", 0), ("merkle", 0), ("hash", 0),
                       ("range", 0), ("own", 0))
    schedules = {
        "EVAL_WARPS": K.EVAL_WARPS,
        "point formulas on five warps, the schedulers' loads even":
            ((F,), (m(0),), (m(1),), (d(0), H, RA), (r(0), r(1)),
             (r(2), r(3)), (d(1),), (r(4), ME, O)),
        "point formulas on four warps, one a scheduler":
            ((r(0), ME), (r(1), r(2)), (r(3), O, H), (r(4), RA), (F,),
             (m(0),), (m(1),), (d(0), d(1))),
        "a round difference on all 8 warps": tuple(
            (r(i % 5),) for i in range(8)),
        "a doubling on all 8 warps": tuple((d(i % 2),) for i in range(8)),
        "a doubling on 4 warps, one a scheduler": (
            (d(0),), (d(1),), (d(0),), (d(1),), (), (), (), ()),
        "a doubling on warp 0 alone": ((d(0),),) + ((),) * 7,
        "nothing (the frame load and the write-out)": ((),) * 8,
    }
    print(f"launch ms at [115, {S}] (CUDA events, {REPS} launches, twice):")
    for name, warps in schedules.items():
        sched = table(warps)
        print(f"  {name}: {ms(sched):.4f} / {ms(sched):.4f}")

    mlib = ctypes.CDLL(paths["micro"])
    mlib.micro_run.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int]
    inp = torch.randint(0, 1 << 62, (1 << 16,), dtype=torch.int64,
                        device=dev)
    ops_per_scheduler = 4 * 256 * 4     # warps a scheduler x ITER x CH
    print("throughput at 2 blocks of 256 threads an SM, 4 chains a thread: "
          "scheduler cycles an op (a warp instruction stream's op)")
    for op, name in enumerate(MICRO_OPS):
        cyc = torch.zeros(2 * 132, dtype=torch.int64, device=dev)
        for _ in range(3):
            if mlib.micro_run(op, inp.data_ptr(), cyc.data_ptr(), 2 * 132):
                raise SystemExit("micro launch failed")
            torch.cuda.synchronize()
        c = float(cyc.float().median())
        print(f"  {name}: {c / ops_per_scheduler:.2f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
