"""The lane facts of the transaction trace on which the layout of
csrc/tx_trace.cu rests, pinned on its plain version (models/trace_device.py
`build_trace_plain`) on the CPU.

The kernel splits a transaction's 1024-row window into column lanes that
run side by side: the Merkle lane (cols 0..57, rows 0..511), the EC lane
(0..37), the h-limb accumulator (38..41), the hash lane (42..55) and the
range lanes (56/57, 92/93) on rows 512..1023, and the columns that are
copies or constants (58..91, and 92/93 on rows 0..511). One plain trace of
three seeded random transactions at depth 3 shows it: transaction 1 is
transaction 0 with only its Merkle inputs changed, transaction 2 with only
its Schnorr and range inputs changed. The accumulator and range columns are
held against closed forms in Python ints, and the plain trace of a real
witness at depth 15 against the JAX package's host rows.

The kernel's EC lane splits each fp6 multiply over a warp and runs the point
formulas in steps of multiplies that do not depend on each other: a
Python-int model of it, slot for slot, is held against ops/ecc.py and the
JAX package's f6_mul for the three forms of the curve constant b3.
Tolerance: exact equality."""
import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine.fieldops import NP
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.ops import ecc as JE
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine.fieldops import BASE
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.models import trace_device as TD
from certificate_stark_tpu_torch.models import transaction as TX
from certificate_stark_tpu_torch.ops import ecc as E
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops import rescue as R
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils.convert import to_jax_limbs

P = F.P
DEPTH = 3
THL = TX.hash_length(DEPTH)
BITS = ("path_bits", "sbits", "hbits", "dbits", "gbits")
MERKLE = ("sibs", "path_bits")          # and init cols 0..64
SCHNORR = ("rx", "msg", "sbits", "hbits", "pkey", "dbits", "gbits")


def _random_tx(rng, depth):
    """One transaction's inputs: random Montgomery values, random bits."""
    out = {}
    for name, shape in K.TRACE_INPUTS:
        shape = (1,) + tuple(depth if s == "d" else s for s in shape)
        out[name] = torch.from_numpy(
            rng.integers(0, 2, size=shape) if name in BITS
            else rng.integers(0, P, size=shape, dtype=np.int64))
    return out


@pytest.fixture(scope="module")
def lanes():
    """(inputs, trace [94, 3, 1024]) of the three transactions."""
    rng = np.random.default_rng(2024)
    tx0, other = _random_tx(rng, DEPTH), _random_tx(rng, DEPTH)
    tx1 = dict(tx0, **{k: other[k] for k in MERKLE})
    tx1["init"] = tx0["init"].clone()
    tx1["init"][:, :65] = other["init"][:, :65]
    tx2 = dict(tx0, **{k: other[k] for k in SCHNORR})
    inputs = {k: torch.cat([tx0[k], tx1[k], tx2[k]]) for k in tx0}
    mds, _, ark = R.tables("cpu")
    consts = dict(gen12=torch.from_numpy(rng.integers(0, P, size=12,
                                                      dtype=np.int64)),
                  b3=F.from_ints(CV.B3_LIMBS, "cpu"), mds=mds, ark=ark)
    trace = TD.build_trace_plain(inputs, consts, DEPTH)
    return inputs, trace.reshape(TX.TRACE_WIDTH, 3, TX.CYCLE)


def _ints(col):
    return [int(v) for v in F.to_ints(col)]


def test_merkle_inputs_reach_only_rows_before_512(lanes):
    _, tr = lanes
    cols = list(range(58)) + [92, 93]
    assert torch.equal(tr[cols, 0, 512:], tr[cols, 1, 512:])
    assert not torch.equal(tr[:58, 0, :512], tr[:58, 1, :512])


def test_schnorr_and_range_inputs_reach_only_rows_from_512(lanes):
    _, tr = lanes
    assert torch.equal(tr[:, 0, :512], tr[:, 2, :512])
    assert not torch.equal(tr[:, 0, 512:], tr[:, 2, 512:])


def test_copy_and_frozen_columns(lanes):
    """Cols 65..91 hold init on all rows; PREV_ROOT (58..64) holds init
    before row thl and the R_UPD digest of row thl from it; the Merkle
    state is frozen from row thl to 511, the hash lane after its 5 sponge
    cycles (rows 552..1023)."""
    inputs, tr = lanes
    for t in range(3):
        init = inputs["init"][t]
        assert torch.equal(tr[65:92, t], init[65:92, None].expand(27, 1024))
        assert torch.equal(tr[58:65, t, :THL],
                           init[58:65, None].expand(7, THL))
        assert torch.equal(tr[58:65, t, THL:],
                           tr[44:51, t, THL:THL + 1].expand(7, 1024 - THL))
        assert torch.equal(tr[:58, t, THL:512],
                           tr[:58, t, THL:THL + 1].expand(58, 512 - THL))
        assert torch.equal(tr[42:56, t, 552:],
                           tr[42:56, t, 552:553].expand(14, 472))


def _binary(bits):
    """Bits, most significant first -> their value mod p."""
    return int("".join(map(str, bits)) or "0", 2) % P


def test_h_limb_accumulator_closed_form(lanes):
    """Cols 38..41 on rows 512 + j: the h bits of the pairs done so far in
    each 64-pair segment (63 in the first), read as a binary number; col
    41 - k holds segment k."""
    inputs, tr = lanes
    segments = ((0, 62), (63, 126), (127, 190), (191, 254))
    for t in range(3):
        hb = [int(b) for b in inputs["hbits"][t]]
        got = [_ints(tr[38 + c, t, 512:]) for c in range(4)]
        for j in range(512):
            done = min((j - 1) // 2, 254) if j else -1
            for k, (lo, hi) in enumerate(segments):
                seq = [hb[254 - r] for r in range(lo, min(hi, done) + 1)]
                assert got[3 - k][j] == _binary(seq), (t, j, k)


@pytest.mark.parametrize("bit_col, key", [(56, "dbits"), (92, "gbits")])
def test_range_lanes_closed_form(lanes, bit_col, key):
    """Rows 513 + s: the bit 63 - s and the accumulator value >> (63 - s),
    held after s = 63; 0 on row 512; on rows 0..511 cols 92/93 hold init
    (56/57 are the R_UPD cluster's there)."""
    inputs, tr = lanes
    for t in range(3):
        bits = [int(b) for b in inputs[key][t]]
        value = sum(b << i for i, b in enumerate(bits))
        got_bit = _ints(tr[bit_col, t, 512:])
        got_acc = _ints(tr[bit_col + 1, t, 512:])
        assert got_bit[0] == got_acc[0] == 0
        for s in range(511):
            i = 63 - min(s, 63)
            assert got_bit[s + 1] == bits[i], (t, s)
            assert got_acc[s + 1] == (value >> i) % P, (t, s)
        if bit_col == 92:
            init = inputs["init"][t]
            assert torch.equal(tr[92:94, t, :512],
                               init[92:94, None].expand(2, 512))


def test_plain_trace_of_a_witness_at_depth_15_equals_jax_tx_rows():
    """2 transactions at depth 15 (the main path's depth), seed 5, fp2 curve
    in both packages, against the JAX package's host rows (`tx_rows`, which
    its own tests hold equal to `build_trace_device`)."""
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    JCV.set_curve("fp2")
    CV.set_curve("fp2")
    try:
        ex = TX.TransactionExample(2, ProofOptions(), depth=15, seed=5,
                                   device="cpu")
        rows = []
        for t, msg, sig in zip(ex.md.tx_dicts(), ex.messages,
                               ex.md.signatures):
            rows.extend(JTX.tx_rows(t, 15, msg, sig))
        exp = JF.from_int(np.array(rows, dtype=object).T)
        assert np.array_equal(to_jax_limbs(ex.trace), exp)
    finally:
        JCV.set_curve(prev[0])
        CV.set_curve(prev[1])


# ---------------------------------------------------------------------------
# A Python-int model of the EC lane of csrc/tx_trace.cu: the fp6 multiply
# split over a warp, and the point formulas as its steps, slot for slot.
# ---------------------------------------------------------------------------
R_INV = pow(1 << 64, -1, P)
W_B3, W_QX, W_QY, W_QXY, D0, D1, D2, D3, D4 = range(9)
X, Y, Z, QX, QY, B3S, HX, HY, HZ = range(9)
S9, S10, S11, S12 = range(9, 13)


def _mul_u(x):
    """x u on each fp2 pair: (x0, x1) -> (2 x1, x0 + 2 x1)."""
    out = list(x)
    for q in range(3):
        d = 2 * x[2 * q + 1] % P
        out[2 * q], out[2 * q + 1] = d, (x[2 * q] + d) % P
    return out


def _mul_v(x):
    """x v: (X0, X1, X2) -> (-X2, X0 - X2, X1) on fp2 coordinates."""
    return [-x[4] % P, -x[5] % P, (x[0] - x[4]) % P, (x[1] - x[5]) % P,
            x[2], x[3]]


class Warp:
    """One point warp's shared memory: 32 fp6 slots (Montgomery ints) and 9
    multiplication matrices, w[m][i][k] = coordinate k of b e_i."""

    def __init__(self):
        self.v = [[0] * 6 for _ in range(32)]
        self.w = [[[0] * 6 for _ in range(6)] for _ in range(9)]

    def wrows(self, srcs, dsts):
        """Step 1: lane 6j + i builds row i = b e_i, e_i = u^(i&1) v^(i>>1),
        of the matrix of slot srcs[j]."""
        for lane in range(6 * len(srcs)):
            j, i = divmod(lane, 6)
            x = list(self.v[srcs[j]])
            if i >= 2:
                x = _mul_v(x)
            if i >= 4:
                x = _mul_v(x)
            if i & 1:
                x = _mul_u(x)
            self.w[dsts[j]][i] = x

    def prods(self, as_, ws, ds, b3mask=0, b3form=2):
        """Step 2: lane 6f + k (lanes 32 on for a sixth multiply) sums the
        unreduced products a_i w[i][k] over the form's range (all 6 in two
        chains, even and odd i) and reduces once. No step may write a slot
        it reads."""
        assert not set(ds) & set(as_)
        out = {}
        for o in range(6 * len(as_)):
            f, k = divmod(o, 6)
            form = b3form if b3mask >> f & 1 else 2
            lo, hi = ((0, 6) if form == 2 else
                      (k & ~1, (k & ~1) + 2) if form == 1 else (k, k + 1))
            chains = [sum(self.v[as_[f]][i] * self.w[ws[f]][i][k]
                          for i in range(lo + j, hi, 2)) for j in (0, 1)]
            c = sum(chains)
            assert c < 1 << 128
            out[ds[f], k] = c * R_INV % P
        for (s, k), val in out.items():
            self.v[s][k] = val

    def lanes(self, fn):
        """Lanes 0..5: coordinate k of an addition step."""
        for k in range(6):
            fn(self.v, k)


def _add(a, b):
    return (a + b) % P


def _sub(a, b):
    return (a - b) % P


def model_double(e, b3form):
    T0, T1, T2, T3, Z3, Y3, ZB, S, X3, T0N, T3N, Y3N, X3N, T0A, T0B, Z3N = \
        range(S9, S9 + 16)
    e.wrows((X, Y, Z), (D0, D1, D2))
    e.prods((X, Y, Z, X, X), (D0, D1, D2, D1, D2), (T0, T1, T2, T3, Z3))

    def a1(v, k):
        v[T3][k] = _add(v[T3][k], v[T3][k])
        v[Z3][k] = _add(v[Z3][k], v[Z3][k])
    e.lanes(a1)
    e.prods((T2, Z3, Y), (W_B3, W_B3, D2), (Y3, ZB, S), 3, b3form)

    def a2(v, k):
        t0, t1, t2 = v[T0][k], v[T1][k], v[T2][k]
        y3 = _add(v[Z3][k], v[Y3][k])
        v[X3][k] = _sub(t1, y3)
        v[Y3][k] = _add(t1, y3)
        v[T3N][k] = _add(_sub(t0, t2), v[ZB][k])
        v[T0N][k] = (3 * t0 + t2) % P
        v[S][k] = _add(v[S][k], v[S][k])
    e.lanes(a2)
    e.wrows((X3, T3N, T1), (D0, D1, D2))
    e.prods((Y3, T3, T0N, S, S), (D0, D0, D1, D1, D2),
            (Y3N, X3N, T0A, T0B, Z3N))

    def a3(v, k):
        v[X][k] = _sub(v[X3N][k], v[T0B][k])
        v[Y][k] = _add(v[Y3N][k], v[T0A][k])
        v[Z][k] = 4 * v[Z3N][k] % P
    e.lanes(a3)


def model_add_mixed(e, b3form):
    SXY, T0, T1, T3, T4, X3, Z3, T1N, T2, Y3, T4B, T5, T4N, T0A, T0B, A1, \
        T0C, A2 = range(S9, S9 + 18)
    e.lanes(lambda v, k: v[SXY].__setitem__(k, _add(v[X][k], v[Y][k])))
    e.prods((X, Y, SXY, Z, Z), (W_QX, W_QY, W_QXY, W_QX, W_B3),
            (T0, T1, T3, T4, X3), 1 << 4, b3form)

    def a1(v, k):
        t0, t1, z1 = v[T0][k], v[T1][k], v[Z][k]
        v[T3][k] = _sub(v[T3][k], _add(t0, t1))
        t4 = v[T4][k] = _add(v[T4][k], v[X][k])
        z3 = _add(v[X3][k], t4)
        v[X3][k] = _sub(t1, z3)
        v[Z3][k] = _add(t1, z3)
        v[T1N][k] = (3 * t0 + z1) % P
        v[T2][k] = _sub(t0, z1)
    e.lanes(a1)
    e.wrows((Z3,), (D0,))
    e.prods((X3, T4, Z), (D0, W_B3, W_QY), (Y3, T4B, T5), 1 << 1, b3form)

    def a2(v, k):
        v[T4N][k] = _add(v[T4B][k], v[T2][k])
        v[T5][k] = _add(v[T5][k], v[Y][k])
    e.lanes(a2)
    e.wrows((T4N, T3), (D1, D2))
    e.prods((T1N, T5, X3, T1N, T5), (D1, D1, D2, D2, D0),
            (T0A, T0B, A1, T0C, A2))

    def a3(v, k):
        v[Y][k] = _add(v[Y3][k], v[T0A][k])
        v[X][k] = _sub(v[A1][k], v[T0B][k])
        v[Z][k] = _add(v[A2][k], v[T0C][k])
    e.lanes(a3)


def model_add(e, b3form):
    SXY1, SXZ1, SYZ1, SXY2, SXZ2, SYZ2, T0, T1, T2, T3, T4, X3B, T4B, T5, \
        Z3, X3, T1N, T4N, Y3, T0A, T0B = range(S9, S9 + 21)
    A1, T0C, A2 = S9, S10, S11

    def a0(v, k):
        v[SXY1][k] = _add(v[X][k], v[Y][k])
        v[SXZ1][k] = _add(v[X][k], v[Z][k])
        v[SYZ1][k] = _add(v[Y][k], v[Z][k])
        v[SXY2][k] = _add(v[HX][k], v[HY][k])
        v[SXZ2][k] = _add(v[HX][k], v[HZ][k])
        v[SYZ2][k] = _add(v[HY][k], v[HZ][k])
    e.lanes(a0)
    e.wrows((HX, HY, HZ, SXY2, SXZ2), (D0, D1, D2, D3, D4))
    e.prods((X, Y, Z, SXY1, SXZ1), (D0, D1, D2, D3, D4), (T0, T1, T2, T3, T4))

    def a1(v, k):
        t0, t1, t2 = v[T0][k], v[T1][k], v[T2][k]
        v[T3][k] = _sub(v[T3][k], _add(t0, t1))
        v[T4][k] = _sub(v[T4][k], _add(t0, t2))
    e.lanes(a1)
    e.wrows((SYZ2,), (D0,))
    e.prods((T2, T4, SYZ1), (W_B3, W_B3, D0), (X3B, T4B, T5), 3, b3form)

    def a2(v, k):
        t0, t1, t2 = v[T0][k], v[T1][k], v[T2][k]
        v[T5][k] = _sub(v[T5][k], _add(t1, t2))
        z3 = _add(v[X3B][k], v[T4][k])
        v[X3][k] = _sub(t1, z3)
        v[Z3][k] = _add(t1, z3)
        v[T1N][k] = (3 * t0 + t2) % P
        v[T4N][k] = _add(v[T4B][k], _sub(t0, t2))
    e.lanes(a2)
    e.wrows((Z3, T4N, T3), (D0, D1, D2))
    e.prods((X3, T1N, T5, X3, T1N, T5), (D0, D1, D1, D2, D2, D0),
            (Y3, T0A, T0B, A1, T0C, A2))

    def a3(v, k):
        v[Y][k] = _add(v[Y3][k], v[T0A][k])
        v[X][k] = _sub(v[A1][k], v[T0B][k])
        v[Z][k] = _add(v[A2][k], v[T0C][k])
    e.lanes(a3)


def _f2mul(a, b):
    u, v, w = a[0] * b[0], a[1] * b[1], (a[0] - a[1]) * (b[1] - b[0])
    c0 = (u + 2 * v) % P
    return [c0, (v + c0 + w) % P]


def _f6inv_std(a):
    """1 / a in fp6 on standard-form ints, the formula the kernel runs on
    one lane (ops/ecc.py f6_inv): fp2 products down to one base-field
    inverse."""
    c0, c1, c2 = a[0:2], a[2:4], a[4:6]
    add = lambda x, y: [(x[j] + y[j]) % P for j in range(2)]
    sub = lambda x, y: [(x[j] - y[j]) % P for j in range(2)]
    c0s, c1s, c2s = _f2mul(c0, c0), _f2mul(c1, c1), _f2mul(c2, c2)
    t = sub(_f2mul(c0, add(c0s, c1s)), _f2mul(c1, c1s))
    t = add(t, _f2mul(add(c0, sub(c2, c1)), c2s))
    tmp = sub(add(c0s, c0s), _f2mul([3 * c0[0] % P, 3 * c0[1] % P], c1))
    t = sub(t, _f2mul(tmp, c2))
    norm = (t[0] * t[0] + 2 * t[0] * t[1] - 2 * t[1] * t[1]) % P
    ni = pow(norm, P - 2, P)
    ti = [(t[0] + 2 * t[1]) * ni % P, -t[1] * ni % P]
    r0 = sub(add(add(c0s, c1s), c2s),
             _f2mul([(2 * c0[0] - c1[0]) % P, (2 * c0[1] - c1[1]) % P], c2))
    r1 = _f2mul(add(_f2mul(c0, c1), c2s), ti)
    r2 = _f2mul(add(sub(c1s, _f2mul(c0, c2)), c2s), ti)
    return _f2mul(r0, ti) + [-v % P for v in r1] + r2


def model_affine_x(e):
    """X = X / Z: the inverse on lane 0, then the split multiply."""
    to_std = lambda vals: [v * R_INV % P for v in vals]
    e.v[S9] = [v * (1 << 64) % P for v in _f6inv_std(to_std(e.v[Z]))]
    e.wrows((S9,), (D0,))
    e.prods((X,), (D0,), (S10,))
    e.v[X] = list(e.v[S10])


def _b3_form(b3):
    return 2 if any(b3[2:]) else 1 if b3[1] else 0


def _warp(rng, b3, q):
    """A warp with a random point in X, Y, Z, the fixed point q (Montgomery
    ints) and b3's matrices built as the kernel builds them."""
    e = Warp()
    mont = [int(v) for v in rng.integers(0, P, size=18, dtype=np.int64)]
    e.v[X], e.v[Y], e.v[Z] = mont[0:6], mont[6:12], mont[12:18]
    e.v[QX], e.v[QY] = q[0:6], q[6:12]
    e.v[B3S] = [v * (1 << 64) % P for v in b3]
    e.v[S9] = [_add(a, b) for a, b in zip(q[0:6], q[6:12])]
    e.wrows((B3S, QX, QY, S9), (W_B3, W_QX, W_QY, W_QXY))
    return e


def _mont_tensor(vals):
    return torch.tensor(vals, dtype=torch.int64)[:, None]


def _b3_cases():
    rng = np.random.default_rng(99)
    full = [int(v) for v in rng.integers(0, P, size=6, dtype=np.uint64)]
    return {"subfield": [3 * v % P for v in CV._load("subfield")["b_limbs"]],
            "fp2": [3 * v % P for v in CV._load("fp2")["b_limbs"]],
            "full_fp6": full}


@pytest.mark.parametrize("b3_name", ["subfield", "fp2", "full_fp6"])
def test_split_fp6_multiply_model_matches_f6_mul(b3_name):
    """The split multiply: a general product, and b3 times a value with
    b3's sparse form, against ops/ecc.py and the JAX package's f6_mul."""
    b3 = _b3_cases()[b3_name]
    rng = np.random.default_rng(7)
    for _ in range(8):
        q = [int(v) for v in rng.integers(0, P, size=12, dtype=np.int64)]
        e = _warp(rng, b3, q)
        e.wrows((Y,), (D0,))
        e.prods((X, Z), (D0, W_B3), (S11, S12), 2, _b3_form(b3))
        x, y, z = (_mont_tensor(e_) for e_ in (e.v[X], e.v[Y], e.v[Z]))
        b3t = F.from_ints(b3, "cpu")[:, None]
        for got, a, b in ((e.v[S11], x, y), (e.v[S12], z, b3t)):
            exp = E.f6_mul(BASE, a, b)
            jexp = JE.f6_mul(NP, to_jax_limbs(a), to_jax_limbs(b))
            assert got == exp[:, 0].tolist()
            assert np.array_equal(to_jax_limbs(exp), np.asarray(jexp))
        assert e.v[S12] == E._mul_b3(BASE, b3, z)[:, 0].tolist()


@pytest.mark.parametrize("b3_name", ["subfield", "fp2", "full_fp6"])
def test_point_formula_model_matches_ecc(b3_name):
    """The kernel's steps of a doubling, a mixed addition, the complete
    addition and the affine x, slot for slot, against ops/ecc.py."""
    b3 = _b3_cases()[b3_name]
    form = _b3_form(b3)
    rng = np.random.default_rng(8)
    q = [int(v) for v in rng.integers(0, P, size=12, dtype=np.int64)]
    e = _warp(rng, b3, q)
    pt = _mont_tensor(e.v[X] + e.v[Y] + e.v[Z])
    model_double(e, form)
    assert e.v[X] + e.v[Y] + e.v[Z] == \
        E.compute_double(BASE, pt, b3)[:, 0].tolist()
    pt = _mont_tensor(e.v[X] + e.v[Y] + e.v[Z])
    model_add_mixed(e, form)
    assert e.v[X] + e.v[Y] + e.v[Z] == \
        E.compute_add_mixed(BASE, pt, _mont_tensor(q), b3)[:, 0].tolist()
    h = [int(v) for v in rng.integers(0, P, size=18, dtype=np.int64)]
    e.v[HX], e.v[HY], e.v[HZ] = h[0:6], h[6:12], h[12:18]
    pt = _mont_tensor(e.v[X] + e.v[Y] + e.v[Z])
    model_add(e, form)
    fin = E.compute_add(BASE, pt, _mont_tensor(h), b3)
    assert e.v[X] + e.v[Y] + e.v[Z] == fin[:, 0].tolist()
    model_affine_x(e)
    x = E.f6_mul(BASE, fin[0:6], E.f6_inv(BASE, fin[12:18]))
    assert e.v[X] == x[:, 0].tolist()
