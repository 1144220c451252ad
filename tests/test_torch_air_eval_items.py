"""transaction_eval's work split (ops/kernels.py `EVAL_ROUNDS`,
`EVAL_WARPS`, `eval_item_slots`), the schedule csrc/air_eval.cu runs a
launch at a time.

The constraints are evaluated item by item with the port's plain field ops
(`rescue_enforce_round` once for each distinct register base, times the
flag of each of its slot ranges; the point formulas of ops/ecc.py; the
Merkle, hash, range and own items slot by slot) and summed: the sum equals
`transaction_eval_plain` for the three forms of b3 and the JAX package's
`TransactionAir.evaluate_transition` for both curves, every item writes
only its declared slots, and the items cover every slot. The kernel itself
runs only on the card: chip_smoke.py holds it against its plain version
there, bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from certificate_stark_tpu.engine.fieldops import NP
from certificate_stark_tpu.engine.options import ProofOptions as JOpts
from certificate_stark_tpu.models import transaction as JTX
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu_torch.engine.fieldops import BASE
from certificate_stark_tpu_torch.models import constraints as CN
from certificate_stark_tpu_torch.ops import ecc as E
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K
from certificate_stark_tpu_torch.ops import rescue as R
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils.convert import to_jax_limbs

S = 64
add, sub, mul = F.add, F.sub, F.mul


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


def _frames(seed):
    """Seeded random cur (a strided view, as the prover passes it), nxt
    [94, S] and periodic [48, S]: every flag a random element, so every
    term of every slot is live."""
    rng = np.random.default_rng(seed)

    def rand(rows, cols):
        return torch.from_numpy(rng.integers(0, F.P, size=(rows, cols),
                                             dtype=np.int64))
    wide = rand(94, S + 9)
    return wide[:, 9:], rand(94, S), rand(48, S)


def _acc(out, slot, v):
    out[slot] = v if slot not in out else add(out[slot], v)


def _items(cur, nxt, per, gen12, b3):
    """{(kind, param): {slot: [S] values}} for every item of EVAL_WARPS,
    with the port's plain field ops; gen12 and b3 standard-form ints."""
    one = F.const(1, "cpu")
    f = per.__getitem__
    doubling, scalar_mult, schnorr_mask = f(7), f(6), f(5)
    addition = mul(sub(one, doubling), scalar_mult)
    final_flag = mul(sub(one, scalar_mult), schnorr_mask)
    items = {}
    for p, (reg, ranges) in enumerate(K.EVAL_ROUNDS):
        diff = CN.rescue_enforce_round(BASE, cur[reg:reg + 14],
                                       nxt[reg:reg + 14], per[20:34],
                                       per[34:48])
        out = items["round", p] = {}
        for slot, flag in ranges:
            for i in range(14):
                _acc(out, slot + i, mul(diff[i], f(flag)))
    for m in range(2):
        off = 19 * m
        c19, n19 = cur[off:off + 19], nxt[off:off + 19]
        rows = E.enforce_point_doubling(BASE, c19, n19, doubling[None], b3)
        items["double", m] = dict(zip(range(off, off + 19), rows))
        pt = nxt[65:77] if m else BASE.embed(gen12, cur).expand(12, S)
        rows = E.enforce_point_addition_mixed(BASE, c19, n19, pt,
                                              addition[None], b3)
        items["mixed", m] = dict(zip(range(off, off + 19), rows))
    rows = E.enforce_point_addition_reduce_x(
        BASE, cur[0:18], nxt[0:18], cur[19:37], final_flag[None], b3)
    items["full", 0] = dict(zip(range(18), rows))

    # Merkle authentication besides its rounds: slots 0..57
    out = items["merkle", 0] = {}
    tx_hash, hash_input = f(1), f(2)
    not_input = sub(one, add(f(4), hash_input))
    copy_flag, init_flag = mul(tx_hash, not_input), mul(tx_hash, hash_input)
    for base in (0, 29):
        bit = nxt[base + 14]
        nbit = sub(one, bit)
        _acc(out, base + 14, mul(sub(mul(bit, bit), bit), tx_hash))
        for reg in (base, base + 15):
            for k in range(7):
                d = sub(cur[reg + k], nxt[reg + k])
                _acc(out, reg + k, add(mul(d, copy_flag),
                                       mul(mul(d, nbit), init_flag)))
                _acc(out, reg + 7 + k, mul(mul(sub(
                    cur[reg + k], nxt[reg + 7 + k]), bit), init_flag))
        for k in range(7):
            _acc(out, base + k, mul(mul(sub(
                nxt[base + 15 + k], nxt[base + k]), bit), init_flag))
            _acc(out, base + 7 + k, mul(mul(sub(
                nxt[base + 22 + k], nxt[base + 7 + k]), nbit), init_flag))

    # Schnorr's h-limbs and hash rows: slots 38..55
    out = items["hash", 0] = {}
    copy_hash = mul(sub(one, f(12)), schnorr_mask)
    for k in range(4):
        vp, df = 41 - k, f(8 + k)
        acc = sub(nxt[vp], add(F.double(cur[vp]), nxt[37]))
        _acc(out, vp, add(mul(acc, mul(df, doubling)),
                          mul(sub(cur[vp], nxt[vp]),
                              mul(sub(one, df), doubling))))
        limb = cur[38 + k]
        _acc(out, 38 + k, add(mul(sub(limb, nxt[38 + k]), addition),
                              mul(sub(limb, cur[42 + k]), final_flag)))
    for k in range(7):
        internal = mul(nxt[65 + k], f(13))
        for j in (1, 2):
            internal = add(internal, mul(nxt[65 + 7 * j + k], f(13 + j)))
        if k < 5:
            internal = add(internal, mul(nxt[86 + k if k < 4 else 91],
                                         f(16)))
        _acc(out, 42 + k, mul(sub(cur[42 + k], nxt[42 + k]), copy_hash))
        _acc(out, 49 + k, mul(sub(nxt[49 + k], internal), copy_hash))

    # the range proof on delta: slots 56, 57
    out = items["range", 0] = {}
    bit = nxt[56]
    _acc(out, 57, mul(sub(nxt[57], add(F.double(cur[57]), bit)), f(17)))
    _acc(out, 56, mul(sub(mul(bit, bit), bit), f(17)))

    # slots 58..114
    out = items["own", 0] = {}
    setup, finish, value_copy = f(0), f(3), f(19)
    for k in range(7):
        root = nxt[58 + k]
        _acc(out, 58 + k, add(mul(sub(root, cur[58 + k]), sub(one, finish)),
                              mul(sub(root, nxt[44 + k]), finish)))
        _acc(out, 92 + k, mul(sub(cur[15 + k], cur[29 + k]), finish))
        _acc(out, 99 + k, mul(sub(nxt[k], cur[58 + k]), finish))
    for k in range(12):
        _acc(out, 65 + k, mul(sub(cur[k], cur[15 + k]), setup))
        _acc(out, 77 + k, mul(sub(cur[29 + k], cur[44 + k]), setup))
    _acc(out, 89, mul(sub(cur[42], cur[57]), setup))
    _acc(out, 90, mul(sub(sub(cur[12], cur[27]), sub(cur[56], cur[41])),
                      setup))
    _acc(out, 91, mul(sub(cur[28], add(cur[13], one)), setup))
    bit = nxt[92]
    _acc(out, 93, mul(sub(nxt[93], add(F.double(cur[93]), bit)), f(17)))
    _acc(out, 92, mul(sub(mul(bit, bit), bit), f(17)))
    srcs = [(101, 0, 65), (103, 29, 77)]
    for slot, origin, pos in srcs:
        for k in range(12):
            _acc(out, slot + k, add(
                mul(sub(nxt[pos + k], cur[origin + k]), setup),
                mul(sub(nxt[pos + k], cur[pos + k]), value_copy)))
    for slot, reg, src in ((105, 89, sub(cur[12], cur[27])),
                           (106, 90, cur[27]), (107, 91, cur[13])):
        _acc(out, slot, add(mul(sub(nxt[reg], src), setup),
                            mul(sub(nxt[reg], cur[reg]), value_copy)))
    delta_eq = mul(sub(nxt[57], nxt[89]), f(18))
    _acc(out, 108, delta_eq)
    _acc(out, 109, delta_eq)
    return items


def _summed(items):
    """The items' slots summed in EVAL_WARPS order -> [115, S]."""
    out = {}
    for warp in K.EVAL_WARPS:
        for item in warp:
            for slot, v in items[item].items():
                _acc(out, slot, v)
    zero = torch.zeros(S, dtype=torch.int64)
    return torch.stack([out.get(s, zero) for s in range(K.TX_SLOTS)])


def _b3(form):
    if form == "full_fp6":
        return [int(v) for v in np.random.default_rng(99).integers(
            0, F.P, size=6, dtype=np.uint64)]
    return [3 * v % F.P for v in CV._load(form)["b_limbs"]]


@pytest.mark.parametrize("form", ["subfield", "fp2", "full_fp6"])
def test_items_sum_to_the_plain_version(form, monkeypatch):
    """The items summed equal transaction_eval_plain (the port's
    evaluate_transition) bit for bit; the round difference is evaluated
    once for each of the five register bases."""
    CV.set_curve("fp2")
    b3 = _b3(form)
    cur, nxt, per = _frames(11 + len(form))
    mds, inv_mds, _ = R.tables("cpu")
    consts = dict(mds=mds, inv_mds=inv_mds, gen12=F.from_ints(CV.GEN12, "cpu"),
                  b3=F.from_ints(b3, "cpu"))
    exp = K.transaction_eval_plain(cur, nxt, per, consts)
    calls = []
    enforce = CN.rescue_enforce_round
    monkeypatch.setattr(CN, "rescue_enforce_round",
                        lambda *a: calls.append(1) or enforce(*a))
    got = _summed(_items(cur, nxt, per, CV.GEN12, b3))
    assert len(calls) == len(K.EVAL_ROUNDS) == 5
    assert torch.equal(got, exp)


@pytest.mark.parametrize("curve", ["fp2", "subfield"])
def test_items_sum_to_the_jax_evaluation(curve):
    """The items summed equal the JAX package's evaluate_transition
    through its numpy facade, on the curve's gen12 and b3."""
    JCV.set_curve(curve)
    CV.set_curve(curve)
    cur, nxt, per = _frames(31 + len(curve))
    got = _summed(_items(cur, nxt, per, CV.GEN12, CV.B3_LIMBS))
    jair = JTX.TransactionAir(2 * 1024, ([11] * 7, [12] * 7),
                              JOpts(num_queries=8, blowup=8,
                                    hash_fn="blake3"), depth=3)
    exp = jair.evaluate_transition(NP, to_jax_limbs(cur), to_jax_limbs(nxt),
                                   to_jax_limbs(per))
    assert np.array_equal(to_jax_limbs(got), np.asarray(exp))


def test_items_write_their_declared_slots_and_cover_all():
    """Every item writes only the slots eval_item_slots declares; the
    items together cover every slot that transaction_eval_plain writes;
    "own" alone writes slots 58..114 (the kernel stores them without the
    shared sums), every other item stays in slots 0..57."""
    CV.set_curve("fp2")
    cur, nxt, per = _frames(5)
    items = _items(cur, nxt, per, CV.GEN12, CV.B3_LIMBS)
    covered = set()
    for (kind, param), out in items.items():
        declared = K.eval_item_slots(kind, param)
        assert set(out) <= declared, (kind, param)
        covered |= declared
        if kind == "own":
            assert declared == set(range(K.EVAL_SHARED_SLOTS, K.TX_SLOTS))
        else:
            assert max(declared) < K.EVAL_SHARED_SLOTS, (kind, param)
    mds, inv_mds, _ = R.tables("cpu")
    consts = dict(mds=mds, inv_mds=inv_mds, gen12=F.from_ints(CV.GEN12, "cpu"),
                  b3=F.from_ints(CV.B3_LIMBS, "cpu"))
    plain = K.transaction_eval_plain(cur, nxt, per, consts)
    assert covered == set(range(plain.shape[0])) == set(range(K.TX_SLOTS))


def test_schedule_table():
    """Five distinct register bases for the nine flagged round ranges;
    every item of every kind once over the 8 warps; the int table the
    launch takes decodes back to EVAL_ROUNDS and EVAL_WARPS."""
    regs = [reg for reg, _ in K.EVAL_ROUNDS]
    assert len(set(regs)) == len(regs) == 5
    assert sum(len(r) for _, r in K.EVAL_ROUNDS) == 9
    assert sorted(flag for _, r in K.EVAL_ROUNDS for _, flag in r) == \
        [0] * 4 + [4] * 4 + [12]
    assert len(K.EVAL_WARPS) == 8
    assert all(1 <= len(w) <= K.EVAL_ITEMS for w in K.EVAL_WARPS)
    counts = dict(round=5, double=2, mixed=2, full=1, merkle=1, hash=1,
                  range=1, own=1)
    assert tuple(counts) == K.EVAL_KINDS
    listed = sorted(item for w in K.EVAL_WARPS for item in w)
    assert listed == sorted((kind, p) for kind, n in counts.items()
                            for p in range(n))
    table = list(K._eval_schedule())
    assert len(table) == 5 * len(K.EVAL_ROUNDS) + 8 * K.EVAL_ITEMS
    for i, (reg, ranges) in enumerate(K.EVAL_ROUNDS):
        row = table[5 * i:5 * i + 5]
        assert row[0] == reg
        assert [tuple(row[1:3]), tuple(row[3:5])][:len(ranges)] == \
            list(ranges)
        assert len(ranges) == 2 or row[3] == -1
    codes = table[5 * len(K.EVAL_ROUNDS):]
    for w, items in enumerate(K.EVAL_WARPS):
        got = codes[K.EVAL_ITEMS * w:K.EVAL_ITEMS * (w + 1)]
        assert [(K.EVAL_KINDS[c >> 3], c & 7) for c in got if c >= 0] == \
            list(items)
        assert got[len(items):] == [-1] * (K.EVAL_ITEMS - len(items))
