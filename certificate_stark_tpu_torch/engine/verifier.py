"""STARK verifier: the port's acceptance check, on the host in Python ints.

Counterpart of certificate_stark_tpu/engine/verifier.py `verify`. The AIR's
own constraint code runs at the single OOD point z through the HostExtOps
facade (engine/fieldops.py), for base-field and extension proofs alike, so
prover and verifier share one constraint definition. The verifier is host
work and takes no device.

Raises VerificationError, its message tagged with the phase that failed:
options, ood, pow, queries, fri, merkle or h.
"""
from __future__ import annotations

import torch

from ..ops import extfield as XF
from ..ops import field as F
from ..ops import ntt as NTT
from ..utils import poly_host as PH
from . import merkle as M
from .air import SequenceAssertion
from .boundary import group_assertions, quotient_degree
from .coin import RandomCoin
from .fieldops import HostExtOps
from .hasher import get_hasher


class VerificationError(Exception):
    pass


def _fail(phase, msg=""):
    raise VerificationError(f"{phase}: {msg}")


class _Ext:
    """Host arithmetic on extension elements as d-tuples of ints."""

    def __init__(self, d):
        self.d = d

    def mul(self, a, b):
        return tuple(XF.host_ext_mul(list(a), list(b), self.d))

    @staticmethod
    def add(a, b):
        return tuple((x + y) % F.P for x, y in zip(a, b))

    @staticmethod
    def sub(a, b):
        return tuple((x - y) % F.P for x, y in zip(a, b))

    def inv(self, a):
        return tuple(XF.host_ext_inv(list(a), self.d))

    def lift(self, x):
        return (int(x) % F.P,) + (0,) * (self.d - 1)

    def pow(self, a, e):
        r, a = self.lift(1), tuple(a)
        while e:
            if e & 1:
                r = self.mul(r, a)
            a = self.mul(a, a)
            e >>= 1
        return r

    def horner(self, coeffs, y):
        """sum_i coeffs[i] y^i for base coefficients at extension y."""
        acc = self.lift(0)
        for c in reversed(coeffs):
            acc = self.add(self.mul(acc, y), self.lift(c))
        return acc


def _regroup(flat, d, phase):
    """Flat element-major ints -> list of d-tuples."""
    if len(flat) % d:
        _fail(phase, "extension values not a multiple of the degree")
    return [tuple(int(v) % F.P for v in flat[i * d:(i + 1) * d])
            for i in range(len(flat) // d)]


def verify(air_class, proof, pub_inputs, air_kwargs=None,
           expected_options=None, min_security=None):
    """Accept `proof` for `air_class(pub_inputs)` or raise
    VerificationError.

    The proof carries its own ProofOptions, so a caller that does not pin
    them would accept a weak proof: pass `expected_options` (rejected on any
    mismatch) or `min_security` (conjectured bits). The Examples pass their
    own options."""
    opts = proof.options
    if expected_options is not None and repr(opts) != repr(expected_options):
        _fail("options", f"proof options {opts!r} != expected "
                         f"{expected_options!r}")
    if min_security is not None and \
            proof.security_level(conjectured=True) < int(min_security):
        _fail("options", f"security {proof.security_level(True)} < "
                         f"required {min_security}")
    n = proof.trace_length
    air = air_class(n, pub_inputs, opts, **(air_kwargs or {}))
    w = proof.trace_width
    assert w == air.trace_width
    b = opts.blowup
    bn = b * n
    d = opts.extension_degree
    offset = F.GENERATOR
    g_trace = PH.root_of_unity(n)
    hasher = get_hasher(opts.hash_fn)
    E = _Ext(d)
    mul, add, sub, inv, lift = E.mul, E.add, E.sub, E.inv, E.lift

    coin = RandomCoin(hasher, opts.context_elements(w, n)
                      + air.pub_inputs_elements())
    coin.reseed(proof.trace_root)

    degrees = air.transition_degrees()
    assertions = air.assertions()
    t_alpha = [tuple(coin.draw_ext(d)) for _ in range(len(degrees))]
    t_beta = [tuple(coin.draw_ext(d)) for _ in range(len(degrees))]
    b_alpha = [tuple(coin.draw_ext(d)) for _ in range(len(assertions))]
    b_beta = [tuple(coin.draw_ext(d)) for _ in range(len(assertions))]
    k = air.ce_blowup()
    comp_deg = k * n - 1

    coin.reseed(proof.h_root)
    z = tuple(coin.draw_ext(d))
    zg = mul(z, lift(g_trace))
    zk = E.pow(z, k)
    coin.reseed(hasher.host_digest(
        list(proof.ood_trace_z) + list(proof.ood_trace_zg)
        + list(proof.ood_h)))

    ood_z = _regroup(proof.ood_trace_z, d, "ood")
    ood_zg = _regroup(proof.ood_trace_zg, d, "ood")
    ood_h = _regroup(proof.ood_h, d, "ood")
    if len(ood_z) != w or len(ood_zg) != w or len(ood_h) != k:
        _fail("ood", "frame size")

    # ---- OOD consistency: C(z) from the constraints == H(z) from H's
    # columns
    fx = HostExtOps(d)
    cur = fx.from_coeffs([list(v) for v in ood_z])
    nxt = fx.from_coeffs([list(v) for v in ood_zg])
    pvals = _periodic_values_at(air, z, E)
    periodic = fx.from_coeffs(pvals) if pvals is not None else None
    evals = air.evaluate_transition(fx, cur, nxt, periodic)
    c_at_z = [tuple(evals[i, 0]) for i in range(evals.shape[0])]

    zt = mul(sub(E.pow(z, n), lift(1)),
             inv(sub(z, lift(pow(g_trace, n - 1, F.P)))))
    zt_inv = inv(zt)
    comp_z = lift(0)
    for alpha, beta, dg, cz in zip(t_alpha, t_beta, degrees, c_at_z):
        q = mul(cz, zt_inv)
        adj = comp_deg - (dg.poly_degree(n) - (n - 1))
        comp_z = add(comp_z, mul(q, add(alpha, mul(beta, E.pow(z, adj)))))

    # boundary terms
    cmap = {id(a): (al, be) for a, al, be in zip(assertions, b_alpha, b_beta)}
    for key, group in group_assertions(assertions, n).items():
        if key[0] == "s":
            zden = sub(z, lift(pow(g_trace, key[1], F.P)))
        else:
            m = n // key[2]
            zden = sub(E.pow(z, m), lift(pow(g_trace, key[1] * m, F.P)))
        zden_inv = inv(zden)
        zadj = E.pow(z, comp_deg - quotient_degree(key, n))
        for a in group:
            alpha, beta = cmap[id(a)]
            if isinstance(a, SequenceAssertion):
                qc = PH.intt([int(v) % F.P for v in a.values])
                y = mul(z, lift(pow(pow(g_trace, a.first_step, F.P),
                                    F.P - 2, F.P)))
                bval = E.horner(qc, y)
            else:
                bval = lift(a.value)
            qv = mul(sub(ood_z[a.column], bval), zden_inv)
            comp_z = add(comp_z, mul(qv, add(alpha, mul(beta, zadj))))

    h_at_z = lift(0)
    for m_i, hv in enumerate(ood_h):
        h_at_z = add(h_at_z, mul(hv, E.pow(z, m_i)))
    if comp_z != h_at_z:
        _fail("ood", f"composition mismatch {comp_z} != {h_at_z}")

    # ---- DEEP coefficients and the FRI coin replay
    g_z = [tuple(coin.draw_ext(d)) for _ in range(w)]
    g_zg = [tuple(coin.draw_ext(d)) for _ in range(w)]
    g_h = [tuple(coin.draw_ext(d)) for _ in range(k)]

    fri_xis = []
    for root in proof.fri_roots:
        coin.reseed(tuple(root))
        fri_xis.append(tuple(coin.draw_ext(d)))
    coin.reseed(hasher.host_digest(list(proof.fri_remainder)))

    if not coin.check_pow(proof.pow_nonce, opts.grinding_bits):
        _fail("pow", "bad nonce")
    coin.reseed(hasher.host_digest([proof.pow_nonce]))
    positions = coin.draw_indices(opts.num_queries, bn)
    if positions != [q.index for q in proof.queries]:
        _fail("queries", "positions mismatch")

    # ---- remainder low-degree check, one extension coordinate at a time
    n_layers = len(proof.fri_roots)
    fold = opts.fri_folding
    rem_n = bn // (fold ** n_layers)
    remainder = _regroup(proof.fri_remainder, d, "fri")
    if len(remainder) != rem_n or rem_n > opts.fri_max_remainder:
        _fail("fri", "remainder size")
    rem_offset = pow(offset, fold ** n_layers, F.P)
    o_inv = pow(rem_offset, F.P - 2, F.P)
    for c in range(d):
        coeffs = PH.intt([r[c] for r in remainder])
        coeffs = [x * pow(o_inv, i, F.P) % F.P for i, x in enumerate(coeffs)]
        if PH.poly_degree(coeffs) >= rem_n // b:
            _fail("fri", "remainder degree too high")

    # ---- per-query checks
    w_big = PH.root_of_unity(bn)
    i4 = PH.root_of_unity(4)
    inv2 = lift(pow(2, F.P - 2, F.P))

    def fold2h(e_x, e_negx, xi, xv):
        s = mul(add(e_x, e_negx), inv2)
        dd = mul(sub(e_x, e_negx), inv2)
        return add(s, mul(mul(xi, dd), lift(pow(xv, F.P - 2, F.P))))

    def deep_term(coeffs, rows, oods):
        acc = lift(0)
        for g, v, o in zip(coeffs, rows, oods):
            acc = add(acc, mul(g, sub(v, o)))
        return acc

    for q in proof.queries:
        pos = q.index
        if not M.verify_path(hasher, proof.trace_root, pos,
                             hasher.host_digest(q.trace_row), q.trace_path):
            _fail("merkle", f"trace path @ {pos}")
        if not M.verify_path(hasher, proof.h_root, pos,
                             hasher.host_digest(q.h_row), q.h_path):
            _fail("merkle", f"h path @ {pos}")
        x = offset * pow(w_big, pos, F.P) % F.P
        h_row = _regroup(q.h_row, d, "h")
        if len(h_row) != k:
            _fail("h", "row size")
        row = [lift(v) for v in q.trace_row]
        deep = add(add(
            mul(deep_term(g_z, row, ood_z), inv(sub(lift(x), z))),
            mul(deep_term(g_zg, row, ood_zg), inv(sub(lift(x), zg)))),
            mul(deep_term(g_h, h_row, ood_h), inv(sub(lift(x), zk))))

        # follow the FRI folding chain
        if len(q.fri_openings) != n_layers:
            _fail("fri", "openings count")
        cur_val, cur_pos, cur_n = deep, pos, bn
        cur_off, cur_gen = offset, w_big
        for li, (vals_flat, path) in enumerate(q.fri_openings):
            quarter = cur_n // fold
            leaf_idx = cur_pos % quarter
            slot = cur_pos // quarter
            if not M.verify_path(hasher, tuple(proof.fri_roots[li]), leaf_idx,
                                 hasher.host_digest(vals_flat), path):
                _fail("fri", f"layer {li} path")
            vals = _regroup(vals_flat, d, "fri")
            if vals[slot] != cur_val:
                _fail("fri", f"layer {li} value mismatch @ {pos}")
            x0 = cur_off * pow(cur_gen, leaf_idx, F.P) % F.P
            xi = fri_xis[li]
            if fold == 4:
                a1 = fold2h(vals[0], vals[2], xi, x0)
                b1 = fold2h(vals[1], vals[3], xi, x0 * i4 % F.P)
                cur_val = fold2h(a1, b1, mul(xi, xi), pow(x0, 2, F.P))
            else:
                cur_val = fold2h(vals[0], vals[1], xi, x0)
            cur_pos = leaf_idx
            cur_n //= fold
            cur_off = pow(cur_off, fold, F.P)
            cur_gen = pow(cur_gen, fold, F.P)
        if remainder[cur_pos] != cur_val:
            _fail("fri", f"remainder mismatch @ {pos}")

    return True


def _periodic_values_at(air, z, E):
    """The periodic column polynomials at the extension point z, as
    coefficient lists. The columns of one length t are interpolated
    together (one inverse NTT of the group, a CPU tensor), and each
    column's value is the dot product of its coefficients with the powers
    of z^(n/t), one extension coordinate at a time (base coefficients times
    extension powers). The same values as interpolating each column and
    Horner at z^(n/t) in Python ints, which took seconds a column at full
    trace length (the Schnorr AIR's public-key and message columns)."""
    cols = air.periodic_columns()
    if cols is None:
        return None
    n = air.trace_length
    by_len = {}
    for i, col in enumerate(cols):
        by_len.setdefault(len(col), []).append(i)
    out = [None] * len(cols)
    for t, idx in by_len.items():
        std = torch.tensor([[int(v) % F.P for v in cols[i]] for i in idx],
                           dtype=torch.int64)
        coeffs = NTT.intt(F.to_mont(std))                       # [C, t]
        y = XF.from_ints([E.pow(z, n // t)], E.d, "cpu")[:, 0]    # [d]
        powers = XF.ext_powers_dyn(y, t, E.d)                     # [d, t]
        vals = F.to_ints(F.mul_sum(coeffs[None], powers[:, None], dim=-1))
        for c, i in enumerate(idx):
            out[i] = [int(v) for v in vals[:, c]]
    return out
