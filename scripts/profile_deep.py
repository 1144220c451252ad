"""Where csrc/deep.cu's `deep` and `ood` kernels spend their time, on the
card: each launch timed whole and with parts of its work taken out.

Builds copies of deep.cu into build/profile_deep/, each with one more part
removed by a text edit (the edits fail loudly if the source no longer
matches), and times `deep` at [94, 2^20] points, k = 8, d = 1 and 3, and
`ood` at [94, 2^20] and [94, 2^17] coefficients, k = 8, d = 1 and 3,
through the wrappers, each copy's library in turn (CUDA events over a
CUDA graph of 10 calls, the median of 3). The copies' results are wrong
from the first edit on; only their time is read:

- kernel:      deep.cu as it is;
- no_mma:      the tensor-core products left out (mma_u8 folds its
               operands into one accumulator word with xors, so that the
               loads feeding it stay);
- no_sums:     also the quad's exchanges and reductions (quad_sums writes
               an accumulator word);
- no_epilogue: also deep's per-point epilogue and inversion, and ood's
               powers (one extension multiply an index and point);
- loads_only:  also the byte transposes into A fragments.

Beside them, the copy of the same trace (torch clone: its bytes read and
written) as the card's streaming rate on this layout.

    python3 scripts/profile_deep.py

Needs a CUDA card and nvcc. Ends with the card's name and power limit.
"""
from __future__ import annotations

import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from certificate_stark_tpu_torch.ops import kernels as K  # noqa: E402

OUT = os.path.join(ROOT, "build", "profile_deep")
W, KC, S, REPS = 94, 8, 1 << 20, 3


def _sub(src, old, new, count=1):
    """src with `old` replaced `count` times by `new`; fails if `old` does
    not occur so often."""
    if src.count(old) != count:
        raise SystemExit(f"profile_deep: deep.cu no longer holds {old!r} "
                         f"{count} time(s)")
    return src.replace(old, new)


def _body(src, head, new_body):
    """src with the body of the function whose definition starts with
    `head` replaced by `new_body`."""
    i = src.find(head)
    if i < 0:
        raise SystemExit(f"profile_deep: deep.cu no longer holds {head!r}")
    j = src.index("{", i)
    depth, k = 0, j
    while True:
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            break
        k += 1
    return src[:j] + "{\n" + new_body + "\n}" + src[k + 1:]


def variants():
    src = open(os.path.join(K.CSRC, "deep.cu")).read()
    out = {"kernel": src}
    src = _body(src, "__device__ __forceinline__ void mma_u8(",
                "    c[0] ^= (int)(a[0] ^ a[1] ^ a[2] ^ a[3] ^ lo32(b) ^ "
                "hi32(b));")
    out["no_mma"] = src
    src = _body(src, "__device__ __forceinline__ void quad_sums(",
                "#pragma unroll\n    for (int j = 0; j < (N + 3) / 4; j++) "
                "out[j] = (u32)acc[0][j % N][j & 3];")
    out["no_sums"] = src
    src = _sub(src, "            if (j < p.S) deep_point<D>(",
               "            if (false) deep_point<D>(")
    src = _sub(src, "u64 inv = inv_base(", "u64 inv = F63_ONE + 0 * (")
    src = _sub(src, "                ext_mul<D>(st, tv, r);",
               "#pragma unroll\n                for (int e = 0; e < D; e++) "
               "r[e] = tv[e] ^ st[e];")
    out["no_epilogue"] = src
    src = _body(src, "__device__ __forceinline__ void a_frags(",
                "#pragma unroll\n    for (int u = 0; u < 4; u++) {\n"
                "        A[u][0] = lo32(v[u]); A[u][1] = hi32(v[u]);\n"
                "        A[u][2] = lo32(v[u + 4]); A[u][3] = hi32(v[u + 4]);\n"
                "    }")
    out["loads_only"] = src
    return out


def build():
    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(K.CSRC, "f63.cuh"), OUT)
    libs = {}
    procs = {}
    for name, text in variants().items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        path = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (path, subprocess.Popen(
            [K._nvcc()] + K.NVCC_FLAGS + ["-o", path, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        regs = re.findall(r"Compiling entry function '_Z11deep_kernelILi(\d)E"
                          r"[^']*'.*?Used (\d+) registers", log, re.S)
        print(f"build {name}: deep registers {dict(regs)}")
        libs[name] = path
    return libs


def device_ms(fn):
    """Device time of one fn() from a CUDA graph of 10 calls (median of
    REPS replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(10):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    times = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("profile_deep: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape):
        return torch.randint(0, K.P, shape, generator=gen, device=dev,
                             dtype=torch.int64)
    calls = {}
    for d in (1, 3):
        args = (rand(W, S), rand(d, KC, S), rand(S), rand(d, 3), rand(d, W),
                rand(d, W), rand(d, KC), rand(d, W), rand(d, W), rand(d, KC))
        calls[f"deep d={d} 2^20"] = (lambda a=args: K.deep(*a))
        for m in (1 << 20, 1 << 17):
            oargs = (rand(W, m), rand(d, KC, m), rand(d, 3), 0)
            calls[f"ood d={d} 2^{m.bit_length() - 1}"] = (
                lambda a=oargs: K.ood(*a))
    rows = {}
    for name, path in libs.items():
        K._LIBS.pop("deep", None)
        K._LIBS["deep"] = K.ctypes.CDLL(path)
        for fn, argtypes in K._ENTRY_POINTS["deep"].items():
            getattr(K._LIBS["deep"], fn).argtypes = argtypes
            getattr(K._LIBS["deep"], fn).restype = K.ctypes.c_int
        rows[name] = {what: device_ms(fn) for what, fn in calls.items()}
        print(f"{name:12s} " + "  ".join(f"{what} {ms:.4f}"
                                          for what, ms in rows[name].items()))
    trace = rand(W, S)
    ms = device_ms(lambda: trace.clone())
    print(f"clone of the [94, 2^20] trace: {ms:.4f} ms, "
          f"{2 * trace.numel() * 8 / ms / 1e9:.3f} TB/s read + written")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
