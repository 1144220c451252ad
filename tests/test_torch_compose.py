"""The transaction AIR's evaluation kernel and the composition kernel,
through their wrappers on the CPU (ops/kernels.py `transaction_eval`,
`compose`: the plain versions, on the kernels' argument layout).

`transaction_eval` is held against the JAX package's
`TransactionAir.evaluate_transition` through its numpy facade (`NP`) for
both curves' b3; `compose` on the flattened tables of real provers against
the composition formula evaluated with Python ints from the AIR's degrees
and assertions alone; a CPU proof of the 2-transaction golden runs through
both wrappers (their plain versions counted, no kernel launched). The
kernels themselves run only on the card: chip_smoke.py holds each against
its plain version there, bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine.fieldops import NP
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine.air import (Assertion,
                                                    SequenceAssertion)
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.engine.prover import Prover
from certificate_stark_tpu_torch.models import schnorr as SC
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils.convert import (from_jax_limbs,
                                                       to_jax_limbs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = JF.P
PUB = ([11] * 7, [12] * 7)
OPTS = dict(num_queries=8, blowup=8, hash_fn="blake3")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def keep_curves():
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    yield
    JCV.set_curve(prev[0])
    CV.set_curve(prev[1])


def _rand(shape, seed):
    """Seeded random elements: (port tensor, JAX limbs)."""
    vals = np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)
    limbs = JF.from_int(vals)
    return from_jax_limbs(limbs), limbs


@pytest.mark.parametrize("curve", ["fp2", "subfield"])
def test_transaction_eval_matches_jax(curve):
    """[94, 2048] random frames, the AIR's periodic columns on the first
    2048 points of its LDE domain: the wrapper (its plain version here)
    on a strided view of the frame equals the JAX evaluation."""
    JCV.set_curve(curve)
    CV.set_curve(curve)
    S = 2048
    air = TX.TransactionAir(2 * TX.CYCLE, PUB, ProofOptions(**OPTS), depth=3)
    jair = JTX.TransactionAir(2 * TX.CYCLE, PUB, JOpts(**OPTS), depth=3)
    per = air.periodic_lde(8, F.GENERATOR, "cpu")[:, :S].contiguous()
    wide, jwide = _rand((94, S + 100), 71)
    nxt, jnxt = _rand((94, S), 72)
    cur = wide[:, 100:]                   # a view, as the prover passes it
    consts = air.eval_consts("cpu")
    assert F.to_ints(consts["b3"]).tolist() == CV.B3_LIMBS
    got = K.transaction_eval(cur, nxt, per, consts)
    exp = jair.evaluate_transition(NP, jwide[:, :, 100:], jnxt,
                                   to_jax_limbs(per))
    assert got.shape == (K.TX_SLOTS, S)
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))
    assert K.transaction_eval.launches == 0


def _sequence_evals(a, x, n, g):
    """B(x) of a sequence assertion: q(x g^-first), q interpolating its
    values at the powers of w = g^period (a naive inverse DFT)."""
    m = len(a.values)
    w = pow(g, a.period, P)
    assert pow(w, m, P) == 1
    m_inv = pow(m, P - 2, P)
    q = [sum(v * pow(w, (P - 1 - k) * i % (P - 1), P)
             for i, v in enumerate(a.values)) * m_inv % P for k in range(m)]
    y = x * pow(pow(g, a.first_step, P), P - 2, P) % P
    return sum(c * pow(y, k, P) for k, c in enumerate(q)) % P


def _composition_at(air, j, evals, lde, coeffs, d):
    """H at point j of the LDE domain with Python ints, from the AIR's
    degrees and assertions: evals [C] and lde [w] standard-form values at
    the point, coeffs the standard-form [d, C] / [d, NB] lists."""
    n, b = air.trace_length, air.options.blowup
    bn, k = n * b, air.ce_blowup()
    comp_deg = k * n - 1
    g = pow(JF.GENERATOR, (P - 1) // n, P)
    x = JF.GENERATOR * pow(pow(JF.GENERATOR, (P - 1) // bn, P), j, P) % P
    t_alpha, t_beta, b_alpha, b_beta = coeffs
    zt_inv = (x - pow(g, n - 1, P)) * pow(pow(x, n, P) - 1, P - 2, P) % P
    out = []
    for e in range(d):
        h = 0
        for c, deg in enumerate(air.transition_degrees()):
            adj = comp_deg - (deg.poly_degree(n) - (n - 1))
            h += evals[c] * (t_alpha[e][c] + t_beta[e][c] * pow(x, adj, P))
        h = h * zt_inv % P
        for i, a in enumerate(air.assertions()):
            if isinstance(a, Assertion):
                z, qd, bx = x - pow(g, a.step, P), n - 2, a.value
            else:
                m = n // a.period
                z = pow(x, m, P) - pow(g, a.first_step * m, P)
                qd = n - 1 - m
                bx = _sequence_evals(a, x, n, g) if isinstance(
                    a, SequenceAssertion) else a.value
            adj = comp_deg - qd
            h += (lde[a.column] - bx) * (b_alpha[e][i] + b_beta[e][i]
                                         * pow(x, adj, P)) \
                * pow(z % P, P - 2, P)
        out.append(h % P)
    return out


def _air(name, d):
    opts = ProofOptions(**OPTS, extension_degree=d)
    if name == "transaction":
        return TX.TransactionAir(2 * TX.CYCLE, PUB, opts, depth=3)
    ex = SC.SchnorrExample(2, opts, device="cpu")
    return ex.air()


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("name", ["transaction", "schnorr"])
def test_compose_matches_python_ints(name, d):
    """compose on a prover's flattened tables, on its last segment (the
    transaction AIR's second: a nonzero offset into the tables), equals
    the formula at sampled points; the Schnorr AIR has per-point sequence
    assertions."""
    CV.set_curve("fp2")
    air = _air(name, d)
    prover = Prover(air, device="cpu", chunk=1024)
    S = prover.chunk
    j0 = prover.bn - S
    if name == "transaction":
        assert j0 > 0
    else:
        assert prover.comp_tabs.b_ev.shape[0] > 0
        assert any(isinstance(a, SequenceAssertion) for a in air.assertions())
    C, NB = len(prover.degrees), len(prover.assertions)
    evals, _ = _rand((C, S), 81 + d)
    lde, _ = _rand((air.trace_width, prover.bn), 82 + d)
    coeffs = [_rand((d, c), 83 + i)[0] for i, c in enumerate((C, C, NB, NB))]
    got = K.compose(evals, lde[:, j0:j0 + S], j0, prover.comp_tabs, *coeffs)
    assert got.shape == (d, S)
    pts = np.random.default_rng(d).choice(S, size=6, replace=False)
    sel = torch.from_numpy(pts)
    ev_i, got_i = F.to_ints(evals[:, sel]), F.to_ints(got[:, sel])
    lde_i = F.to_ints(lde[:, j0 + sel])
    co_i = [F.to_ints(c).tolist() for c in coeffs]
    for k, i in enumerate(pts):
        exp = _composition_at(air, j0 + int(i), ev_i[:, k].tolist(),
                              lde_i[:, k].tolist(), co_i, d)
        assert got_i[:, k].tolist() == exp
    assert K.compose.launches == 0


def test_golden_proof_runs_through_both_wrappers(monkeypatch):
    """The 2-transaction golden proven on the CPU: one evaluation and one
    composition through the wrappers' plain versions, no kernel launched,
    the golden's bytes."""
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        g = json.load(f)["transaction_2tx_d3_blake3"]
    CV.set_curve(g["curve"])
    calls = {"transaction_eval": 0, "compose": 0}

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run
    monkeypatch.setattr(K, "transaction_eval_plain", counted(
        "transaction_eval", K.transaction_eval_plain))
    monkeypatch.setattr(K, "compose_plain", counted(
        "compose", K.compose_plain))
    ex = TX.TransactionExample(g["num_transactions"],
                               ProofOptions(**g["options"]),
                               depth=g["depth"], seed=g["seed"], device="cpu")
    prover = Prover(ex.air(), device="cpu")
    K.reset_launches()
    raw = prover.prove(ex.trace).to_bytes()
    assert hashlib.sha256(raw).hexdigest() == g["proof_sha256"]
    assert calls == {"transaction_eval": 1, "compose": 1}
    assert K.transaction_eval.launches == K.compose.launches == 0
