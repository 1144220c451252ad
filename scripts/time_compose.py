"""The compose kernel's time at extension degrees 1, 2 and 3, for comparing
two checkouts on one card.

    python3 scripts/time_compose.py [--root DIR]

imports certificate_stark_tpu_torch from DIR (default: this checkout),
which builds its kernels at first use into DIR/build/torch_kernels. On the
128-transaction, depth-15 AIR's Prover tables with bench options and a
random trace LDE (chip_smoke.py `_randoms`), it evaluates the first
2^20-point segment's constraints with transaction_eval, then for each d
checks compose bit for bit against its plain version on random
coefficients (chip_smoke.py `_random_coeffs`, seed 10 + d) and times it
with CUDA events, 20 launches after a warm-up, three times. Prints one
JSON line (the root, the SHA-256 of its csrc/compose.cu, the ms by degree)
and then the card's name and power limit. The inputs are the same in
every checkout, so to compare the parent with a change in one call,
unpack the parent into a git-ignored directory and run in turns:

    for r in build/parent . . build/parent; do
        python3 scripts/time_compose.py --root $r; done

Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    from certificate_stark_tpu_torch.engine.options import ProofOptions
    from certificate_stark_tpu_torch.engine.prover import Prover
    from certificate_stark_tpu_torch.models import transaction as TX
    from certificate_stark_tpu_torch.ops import kernels as K
    from certificate_stark_tpu_torch.utils import curve as CV
    assert os.path.dirname(os.path.dirname(K.CSRC)) == root, K.CSRC
    sys.path.insert(1, HERE)
    import chip_smoke as CS

    if not torch.cuda.is_available():
        raise SystemExit("time_compose: no CUDA device")
    dev = torch.device("cuda")
    CV.set_curve("fp2")
    air = TX.TransactionAir(CS.TX_COUNT * TX.CYCLE, ([1] * 7, [2] * 7),
                            ProofOptions(**CS.BENCH_OPTS), depth=CS.TX_DEPTH)
    prover = Prover(air, device=dev)
    lde = CS._randoms(dev)(TX.TRACE_WIDTH, prover.bn)
    S = prover.chunk
    cur, nxt = prover._frame(lde, 0, S)
    evals = K.transaction_eval(cur, nxt, prover.periodic, prover.eval_consts)
    ms_by_d = {}
    for d in (1, 2, 3):
        coeffs = CS._random_coeffs(prover, 10 + d, d)
        got = K.compose(evals, cur, 0, prover.comp_tabs, *coeffs)
        with K.plain_versions():
            exp = K.compose(evals, cur, 0, prover.comp_tabs, *coeffs)
        CS.check(torch.equal(got, exp),
                 f"compose differs from its plain version (d = {d})")
        ms_by_d[d] = [CS.cuda_ms(lambda: K.compose(
            evals, cur, 0, prover.comp_tabs, *coeffs), 20) for _ in range(3)]
    with open(os.path.join(K.CSRC, "compose.cu"), "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:16]
    print(json.dumps(dict(root=root, compose_cu=sha, shape=[
        len(prover.comp_tabs.t_idx), S], ms_by_d=ms_by_d)))
    print(CS.card_line())


if __name__ == "__main__":
    main()
