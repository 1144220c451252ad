"""The launch plan of the ntt and lde kernels (ops/kernels.py `ntt_plan`,
csrc/ntt.cu) replayed on the CPU against the JAX package. Tolerance: exact
equality.

`_replay` is a model of the kernel, written from csrc/ntt.cu line for
line: each pass's blocks (cosets r0, groups j0 or K0, the fixed high
digits H and i''', the column c), the first round's units loading the
bit-reversed points straight from the input (the LDE's units loading each
coefficient once, scaling it by (o w_bn^r0)^t and running the R cosets
from it, each coset the previous one times w_bn^t), the register
rounds of radix-2 stages with the staged twiddles (`round_twiddles`; the
first round's w^0 = 1 not multiplied), the swizzled tile slots between
rounds (a unit's base XOR the round's per-register bits), and the last
round's stores with the twiddle w_n^(j k) or w_n^((i''' k) T_p) (the
LDE's from its direct table; the inverse's first pass's times 1/n), and
the last pass's scale: 1/n where one pass has no twiddle, or the fused
s^t (times 1/n where one pass).
The arithmetic is canonical here; the kernel's lazy outputs are congruent
(tests/test_torch_ntt_words.py). It uses the wrappers' tables
(`ntt_tables`, `lde_tables`, `scale_tables`) and
checks that every round writes each tile slot once, that every pass
writes each output point once and that a later pass's block stores
exactly the points it loads (in place). The plans run at n = 2^0 .. 2^12
with tiles of 2^2 .. 2^4 points, so that plans of one to twelve passes
run, against utils/poly_host.py's transforms; the fused inverse also at
the full tile (tests/test_torch_ntt.py holds it against the JAX
package's coset_scale over intt). The
proof-size plans are checked for their shared memory and for one
wavefront a half-warp at every tile access."""
import re

import numpy as np
import pytest
import torch

from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import poly_host as JPH
from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.ops import kernels as K

P = JF.P
TILES = (4, 8, 16)
LOGS = range(13)
LDE_CASES = ((0, 1), (0, 2), (0, 256), (1, 1), (1, 2), (1, 256), (3, 8),
             (5, 4), (7, 8), (9, 2))
MAX_SMEM = 232448     # dynamic shared memory a block of the H100
THREADS = 256         # csrc/ntt.cu NTT_THREADS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs a worker process per core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ints(C, logn, seed):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in row] for row in
            rng.integers(0, P, size=(C, 1 << logn), dtype=np.uint64)]


def _brev(x, bits):
    out = torch.zeros_like(x)
    for k in range(bits):
        out |= ((x >> k) & 1) << (bits - 1 - k)
    return out


def _brev_c(m, bits):
    return int(_brev(torch.tensor(m), bits))


def _split(lo, hi, h, e):
    return K.mul_plain(lo[e & ((1 << h) - 1)], hi[e >> h])


def _swz(s, swizzle):
    """csrc/ntt.cu `swz`: the tile's XOR-linear swizzle of slot s."""
    c, sh, mask = swizzle
    return s ^ (((s >> c) & mask) << sh)


def _bits(k, q, swizzle):
    """csrc/ntt.cu `Bits`: swz(m << q) for m < 2^k, as the XOR of the set
    bits' swz(1 << (q + i))."""
    b = [_swz(1 << (q + i), swizzle) for i in range(k)]
    out = []
    for m in range(1 << k):
        r = 0
        for i in range(k):
            if (m >> i) & 1:
                r ^= b[i]
        out.append(r)
    return out


def _slot(idx, u, lRG, swizzle):
    return _swz((idx << lRG) | u, swizzle)


def _dit(v, k, first, w, s, lo):
    """csrc/ntt.cu `dit`: k radix-2 stages on the unit's 2^k points."""
    for t in range(k):
        for m in range(1 << k):
            if m & (1 << t):
                continue
            ml, mh = m & ((1 << t) - 1), m | (1 << t)
            y = v[mh]
            if not first:
                y = K.mul_plain(y, w[((((1 << t) - 1 + ml)) << s) + lo])
            elif ml:
                y = K.mul_plain(y, w[(1 << t) - 1 + ml])
            x = v[m]
            v[m] = K._add_plain(x, y)
            v[mh] = K._sub_plain(x, y)


def _replay(x, inverse=False, blowup=None, offset=None, scale_by=None,
            tile=K.NTT_TILE):
    """csrc/ntt.cu's passes on x [C, n] as the wrappers launch them (ntt
    where blowup is None, else lde) -> [C, blowup n]; and the plan."""
    C, n = x.shape
    lde = blowup is not None
    b = blowup or 1
    L, lb = n.bit_length() - 1, b.bit_length() - 1
    bn = b * n
    plan = K.ntt_plan(n, b, tile, lde=lde)
    logs = [ps["log"] for ps in plan]
    tabs = K.ntt_tables(n, inverse, K._ntt_key(plan), "cpu")
    one = len(plan) == 1        # else pass 0's twiddles carry 1/n
    scale = 0
    if lde:
        tw_n = K.direct_table(n)
        bw, (s_lo, s_hi, h_s) = K.lde_tables(n, b, offset % P, "cpu")
    elif scale_by is not None:
        s_lo, s_hi, h_s = K.scale_tables(n, scale_by % P, "cpu", one)
        scale = 2
    elif inverse and one:
        scale = 1
    src = x.reshape(-1)
    out = torch.full((C * bn,), -1, dtype=torch.int64)
    for p, ps in enumerate(plan):
        lp, lR, lG = ps["log"], ps["log_R"], ps["log_G"]
        rounds, swz = ps["rounds"], ps["swizzle"]
        assert ps["points"] <= tile and ps["smem_bytes"] <= MAX_SMEM
        assert sum(rounds) == lp and len(rounds) <= K.NTT_MAX_ROUNDS
        assert all((lp > 0) <= k <= K.NTT_KMAX for k in rounds)
        last = p == len(plan) - 1
        lgT = sum(logs[:p])
        lgS = L - lgT - lp
        lRG = lR + lG
        R, RG, pts = 1 << lR, 1 << lRG, 1 << (lRG + lp)
        # the block: its cosets r0 + [0, R), then its group and fixed digits
        blk = torch.arange(C << (lb + L - lRG - lp))[:, None]
        r0 = (blk & ((1 << (lb - lR)) - 1)) << lR
        rest = blk >> (lb - lR)
        j0 = K0 = H = i3 = torch.zeros_like(blk)
        if p == 0:
            lgj = lgS - lG
            j0 = (rest & ((1 << lgj) - 1)) << lG
            c = rest >> lgj
        else:
            lgk = lgT - lG
            K0 = (rest & ((1 << lgk) - 1)) << lG
            rest = rest >> lgk
            H = rest & ((1 << lgS) - 1)
            c = rest >> lgS
            rem, sw = H, lgS
            for q in range(p + 1, len(logs)):
                sw -= logs[q]
                i3 = i3 | ((rem & ((1 << logs[q]) - 1)) << sw)
                rem = rem >> logs[q]
        rt = tabs.rounds[p]
        tw = (tabs.tw_lo, tabs.tw_hi0 if p == 0 else tabs.tw_hi, tabs.h_tw)
        tile_ = torch.full((blk.shape[0], pts), -1, dtype=torch.int64)
        loaded, stored = [], []

        def tile_io(sl, vals=None):
            """Reads (vals None) or writes the tile slots sl."""
            sl = sl.expand(blk.shape[0], -1)
            if vals is None:
                return tile_.gather(1, sl)
            tile_.scatter_(1, sl, vals)
            written.append(sl)

        def store(v, u, s, lo):
            """csrc/ntt.cu `store`: outputs k_m = m 2^s + lo of column u."""
            rr, g = u & (R - 1), u >> lR
            if p == 0:
                j = j0 + g
                Hj, rem, sh = torch.zeros_like(j), j, L - lp
                for q in range(len(logs) - 1, 0, -1):
                    sh -= logs[q]
                    Hj = Hj | ((rem & ((1 << logs[q]) - 1)) << sh)
                    rem = rem >> logs[q]
                pos = r0 + rr + ((lo + (Hj << lp)) << lb)
                step = 1 << (s + lb)
                e, estep = j * lo, j << s
            else:
                pos = r0 + rr + ((K0 + g + (lo << lgT) + (H << (lgT + lp)))
                                 << lb)
                step = 1 << (s + lgT + lb)
                e, estep = (i3 * lo) << lgT, i3 << (s + lgT)
            for m, val in enumerate(v):
                if not last:
                    assert int((e + m * estep).max()) < n
                    val = K.mul_plain(val, tw_n[e + m * estep] if lde else
                                      _split(*tw, e + m * estep))
                elif scale == 1:
                    val = K.mul_plain(val, torch.tensor(tabs.ninv))
                elif scale == 2:
                    val = K.mul_plain(val, _split(s_lo, s_hi, h_s,
                                                  pos + m * step))
                at = (c * bn + pos + m * step).expand_as(val)
                stored.append(at)
                out[at.reshape(-1)] = val.reshape(-1)

        # ---- the first round
        k, written = rounds[0], []
        lh = lp - k
        if lde and p == 0:
            e = torch.arange(1 << (lG + lh))[None, :]
            hb, g = e & ((1 << lh) - 1), e >> lh
            t0 = (_brev(hb, lh) << lgS) + j0 + g
            tstep = 1 << (lh + lgS)
            y, z = [], []
            for m in range(1 << k):
                t = t0 + _brev_c(m, k) * tstep
                ym = K.mul_plain(src[c * n + t], _split(s_lo, s_hi, h_s, t))
                ym = torch.where(r0 != 0, K.mul_plain(
                    ym, _split(*bw, r0 * t)), ym)
                y.append(ym)
                z.append(_split(*bw, t))
            ms = _bits(k, lRG, swz)
            base = _swz((hb << (k + lRG)) | (g << lR), swz)
            for rr in range(R):
                v = list(y)
                _dit(v, k, True, rt, 0, 0)
                if len(rounds) == 1:
                    store(v, (g << lR) | rr, 0, 0)
                else:
                    br = base ^ _swz(rr, swz)
                    for m in range(1 << k):
                        tile_io(br ^ ms[m], v[m])
                if rr + 1 < R:
                    y = [K.mul_plain(ym, zm) for ym, zm in zip(y, z)]
        else:
            e = torch.arange(1 << (lRG + lh))[None, :]
            u, hb = e & (RG - 1), e >> lRG
            rr, g = u & (R - 1), u >> lR
            dh = _brev(hb, lh)
            if p == 0:
                base = (dh << lgS) + j0 + g
                dstep = 1 << (lh + lgS)
            else:
                base = r0 + rr + ((K0 + g + (dh << lgT) + (H << (lgT + lp)))
                                  << lb)
                dstep = 1 << (lh + lgT + lb)
            v = []
            for m in range(1 << k):
                at = base + _brev_c(m, k) * dstep
                if p == 0:
                    v.append(src[c * n + at])
                else:
                    loaded.append(at.expand(blk.shape[0], -1))
                    v.append(out[c * bn + at])
            _dit(v, k, True, rt, 0, 0)
            if len(rounds) == 1:
                store(v, u, 0, 0)
            else:
                ms = _bits(k, lRG, swz)
                base = _swz((hb << (k + lRG)) | u, swz)
                for m in range(1 << k):
                    tile_io(base ^ ms[m], v[m])
        # ---- the later rounds, each after a barrier
        s, off = k, (1 << k) - 1
        for rho in range(1, len(rounds)):
            # the round before wrote every slot once
            assert torch.equal(torch.cat(written, 1).sort(1).values,
                               torch.arange(pts).expand(blk.shape[0], -1))
            k, written = rounds[rho], []
            e = torch.arange(1 << (lRG + lp - k))[None, :]
            u, q = e & (RG - 1), e >> lRG
            lo, hb = q & ((1 << s) - 1), q >> s
            ms = _bits(k, s + lRG, swz)
            base = _swz((((hb << (s + k)) | lo) << lRG) | u, swz)
            v = [tile_io(base ^ ms[m]) for m in range(1 << k)]
            _dit(v, k, False, rt[off:], s, lo)
            if rho == len(rounds) - 1:
                store(v, u, s, lo)
            else:
                for m in range(1 << k):
                    tile_io(base ^ ms[m], v[m])
            off += ((1 << k) - 1) << s
            s += k
        stored = torch.cat(stored, 1)
        if p > 0:   # in place: a block stores the points it loaded
            assert torch.equal(stored.sort(1).values,
                               (c * bn + torch.cat(loaded, 1))
                               .sort(1).values)
        assert torch.equal(stored.reshape(-1).sort().values,
                           torch.arange(C * bn))
    return out.reshape(C, bn), plan


def _lde_ref(col, blowup, offset):
    scaled = [v * pow(offset, t, P) % P for t, v in enumerate(col)]
    return JPH.ntt(scaled + [0] * ((blowup - 1) * len(col)))


@pytest.mark.parametrize("tile", TILES)
def test_replayed_ntt_and_intt_match_jax_host_transforms(tile):
    passes = set()
    for logn in LOGS:
        cols = _ints(2, logn, logn)
        x = F.from_ints(cols, "cpu")
        for inverse, ref in ((False, JPH.ntt), (True, JPH.intt)):
            got, plan = _replay(x, inverse, tile=tile)
            assert [list(r) for r in F.to_ints(got)] == \
                [ref(c) for c in cols], (tile, logn, inverse)
            passes.add(len(plan))
    assert 1 in passes and max(passes) >= 3
    assert tile == 4 or 2 in passes      # tile 4: passes of one radix-2 stage


@pytest.mark.parametrize("tile", TILES)
def test_replayed_lde_matches_jax_host_lde(tile):
    """Blowups 1, 2, 8 and 2^8, n = 1 and 2, and a shifted offset (the
    sequence assertions' engine/boundary.py:78 case: the domain offset
    times g^-first)."""
    g_inv = pow(JPH.root_of_unity(1 << 6), P - 2, P)
    for i, (logn, blowup) in enumerate(LDE_CASES):
        offset = JF.GENERATOR * pow(g_inv, 5 + i, P) % P if i % 2 \
            else JF.GENERATOR
        cols = _ints(2, logn, 100 + i)
        got, _ = _replay(F.from_ints(cols, "cpu"), blowup=blowup,
                         offset=offset, tile=tile)
        assert [list(r) for r in F.to_ints(got)] == \
            [_lde_ref(c, blowup, offset) for c in cols], (tile, logn, blowup)


def _fused_ref(col, scale_by):
    return [v * pow(scale_by, t, P) % P for t, v in enumerate(JPH.intt(col))]


@pytest.mark.parametrize("tile", TILES)
def test_replayed_fused_inverse_matches_jax_host(tile):
    """The fused inverse n^-1 s^t at d = 1, 2, 3 columns (the composition's
    [d, bn]) with s = 1/offset, at 2^0 .. 2^12 points: plans of one to
    twelve passes, the scale in the last one."""
    s = pow(JF.GENERATOR, P - 2, P)
    for logn in LOGS:
        cols = _ints(1 + logn % 3, logn, 200 + logn)
        got, _ = _replay(F.from_ints(cols, "cpu"), True, scale_by=s,
                         tile=tile)
        assert [list(r) for r in F.to_ints(got)] == \
            [_fused_ref(c, s) for c in cols], (tile, logn)


@pytest.mark.parametrize("logn", [13, 14])
def test_replayed_fused_inverse_at_the_full_tile(logn):
    """At the full tile (2^13 points: one pass of four rounds; 2^14: two
    passes of 2^7), d = 3 columns as the cubic composition's iNTT with s =
    1/offset, against poly_host's intt scaled by s^t."""
    o_inv = pow(JF.GENERATOR, P - 2, P)
    cols = _ints(3, logn, 300 + logn)
    got, plan = _replay(F.from_ints(cols, "cpu"), True, scale_by=o_inv)
    assert len(plan) == (1 if logn <= 13 else 2)
    assert [list(r) for r in F.to_ints(got)] == \
        [_fused_ref(c, o_inv) for c in cols]


def _wavefronts(ps, lde, first):
    """The most wavefronts a half-warp of 16 lanes takes at one u64 tile
    access of the pass's rounds (a block of THREADS threads, unit e =
    thread + i THREADS, so 16 lanes are 16 consecutive units): its slots,
    all distinct, in one of the 16 bank pairs."""
    lp, lR, lG = ps["log"], ps["log_R"], ps["log_G"]
    rounds, swz, lRG = ps["rounds"], ps["swizzle"], lR + lG
    worst, s = 0, 0
    for rho, k in enumerate(rounds):
        if rho == 0 and len(rounds) == 1:
            break
        if rho == 0 and lde and first:     # lanes along hb, then g
            e = torch.arange(1 << (lG + lp - k))
            hb, u = e & ((1 << (lp - k)) - 1), (e >> (lp - k)) << lR
            idx = [(hb << k) | m for m in range(1 << k)]
        else:
            e = torch.arange(1 << (lRG + lp - k))
            u, q = e & ((1 << lRG) - 1), e >> lRG
            lo, hb = q & ((1 << s) - 1), q >> s
            idx = [(hb << (s + k)) | (m << s) | lo for m in range(1 << k)]
        for ix in idx:
            sl = _slot(ix, u, lRG, swz)
            half = sl[:sl.numel() // 16 * 16].reshape(-1, 16)
            assert torch.equal(half.sort(1).values.diff(1).clamp(max=1),
                               torch.ones(half.shape[0], 15,
                                          dtype=torch.int64))
            per_bank = torch.zeros(half.shape[0], 16, dtype=torch.int64)
            per_bank.scatter_add_(1, half % 16, torch.ones_like(half))
            worst = max(worst, int(per_bank.max()))
        s += k
    return worst


@pytest.mark.parametrize("blowup", [1, 8])
@pytest.mark.parametrize("logn", [17, 20, 23])
def test_plans_of_the_proof_sizes(logn, blowup):
    """At 2^17, 2^20 and 2^23 points: at most two passes, each block's
    tile and staged twiddles within the card's shared memory, with two
    groups or more where the pass has a strided side, register rounds of
    at most four stages (the LDE's first of two, its units running the
    cosets), one wavefront a half-warp at every tile access of the plans
    the paths launch, and a grid of fewer than 2^31 blocks at 94
    columns."""
    src = open(K.os.path.join(K.CSRC, "ntt.cu")).read()
    for name, val in (("NTT_TILE_LOG", K.NTT_TILE.bit_length() - 1),
                      ("NTT_MAX_ROUNDS", K.NTT_MAX_ROUNDS),
                      ("NTT_KMAX", K.NTT_KMAX), ("NTT_LDE_K0", K.NTT_LDE_K0),
                      ("NTT_THREADS", THREADS)):
        assert re.search(rf"^#define {name} {val}\b", src, re.M), name
    for lde in ((False, True) if blowup > 1 else (False,)):
        plan = K.ntt_plan(1 << logn, blowup, lde=lde)
        assert len(plan) == 2 and sum(ps["log"] for ps in plan) == logn
        for p, ps in enumerate(plan):
            assert ps["points"] <= K.NTT_TILE
            # 3 blocks an SM (2 at 2^23: the 2^12-point pass's twiddles)
            assert ps["smem_bytes"] <= MAX_SMEM // (3 if logn <= 20 else 2)
            assert ps["log"] <= K.NTT_TILE.bit_length() - 2
            assert ps["log_R"] == min(blowup.bit_length() - 1,
                                      13 - ps["log"])
            assert ps["log_G"] >= 1 or ps["log_R"] + ps["log"] == 13
            assert 94 * ps["blocks"] < 1 << 31
            # two barriers a pass (three in the LDE's first 2^12-point one)
            assert len(ps["rounds"]) <= 3 + (lde and p == 0 and logn == 23)
            assert max(ps["rounds"]) <= 4
            assert ps["rounds"][0] <= (2 if lde and p == 0 else 4)
            if not (lde and logn == 23):      # no path runs that LDE
                assert _wavefronts(ps, lde, p == 0) == 1, (lde, p, ps)
    assert K.ntt_plan(1 << 13, blowup)[0]["log"] == 13
    assert K.ntt_plan(1 << 13, blowup)[0]["rounds"] == [4, 3, 3, 3]
