"""The launch plan of the ntt and lde kernels (ops/kernels.py `ntt_plan`,
csrc/ntt.cu) replayed on the CPU against the JAX package. Tolerance: exact
equality.

`_replay` is a model of the kernel's index math, written from
csrc/ntt.cu line for line: each pass's blocks (cosets r0, groups j0 or
K0, the fixed high digits H, the column c), the bit-reversed loads, the
LDE's factor o^t w_bn^(r t) at the first pass's loads, the radix-2
butterflies on the tile, the twiddle w_n^(T_p k_p i''') and the 1/n of
the inverse's last pass at the stores, and the r + b idx interleave of the
stores. It uses the wrapper's tables (`ntt_tables`, `lde_tables`) and
checks that every pass writes each output point once and that a later
pass's block stores exactly the points it loads (in place). The plans run
at n = 2^0 .. 2^12 with tiles of 2^2 .. 2^4 points, so that plans of one
to twelve passes run, against utils/poly_host.py's transforms."""
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


def _split(lo, hi, h, e):
    return K.mul_plain(lo[e & ((1 << h) - 1)], hi[e >> h])


def _replay(x, inverse=False, blowup=None, offset=None, tile=K.NTT_TILE):
    """csrc/ntt.cu's passes on x [C, n] as the wrappers launch them (ntt
    where blowup is None, else lde) -> [C, blowup n]; and the plan."""
    C, n = x.shape
    b = blowup or 1
    L, lb = n.bit_length() - 1, b.bit_length() - 1
    plan = K.ntt_plan(n, b, tile)
    logs = tuple(ps["log"] for ps in plan)
    tabs = K.ntt_tables(n, inverse, logs, "cpu")
    if blowup:
        (o_lo, o_hi, h_o), (c_lo, c_hi, h_c) = K.lde_tables(n, b, offset % P,
                                                            "cpu")
    src = x.reshape(-1)
    out = torch.full((C * b * n,), -1, dtype=torch.int64)
    for p, ps in enumerate(plan):
        lp, lR, lG = ps["log"], ps["log_R"], ps["log_G"]
        assert ps["points"] <= tile and ps["smem_bytes"] <= MAX_SMEM
        lgT = sum(logs[:p])
        lgS = L - lgT - lp
        R, G = 1 << lR, 1 << lG
        RG, pts = R * G, (R * G) << lp
        blk = torch.arange(C << (lb + L - lR - lG - lp))[:, None]
        e = torch.arange(pts)[None, :]
        r0 = (blk & ((b >> lR) - 1)) << lR
        rest = blk >> (lb - lR)
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
        # load, bit reversed
        r, g, d = e & (R - 1), (e >> lR) & (G - 1), e >> (lR + lG)
        slot = ((_brev(d, lp) << lG) + g) * R + r
        if p == 0:
            t = (d << lgS) + j0 + g
            v = src[c * n + t]
            if blowup:
                v = K.mul_plain(v, _split(o_lo, o_hi, h_o, t))
                v = K.mul_plain(v, _split(c_lo, c_hi, h_c, (r0 + r) * t))
        else:
            loaded = r0 + r + b * (K0 + g + (d << lgT) + (H << (lgT + lp)))
            v = out[c * b * n + loaded]
        tile_ = torch.zeros_like(v).scatter_(1, slot.expand_as(v), v)
        # radix-2 stages
        bf = torch.arange(pts // 2)
        u, jj = bf & (RG - 1), bf >> (lR + lG)
        for s in range(lp):
            pos = jj & ((1 << s) - 1)
            lo = ((jj >> s) << (s + 1)) + pos
            w = tabs.stages[p][pos << (lp - 1 - s)]
            il, ih = lo * RG + u, (lo + (1 << s)) * RG + u
            xa, y = tile_[:, il], K.mul_plain(tile_[:, ih], w)
            tile_[:, il] = K._add_plain(xa, y)
            tile_[:, ih] = K._sub_plain(xa, y)
        # store, with the twiddle and 1/n
        last = p == len(plan) - 1
        if p == 0:
            r, k, g = e & (R - 1), (e >> lR) & ((1 << lp) - 1), e >> (lR + lp)
            j = j0 + g
            Hj, rem, suf = torch.zeros_like(j), j, 0
            for q in range(len(logs) - 1, 0, -1):
                suf += logs[q]
                Hj |= (rem & ((1 << logs[q]) - 1)) << (L - lp - suf)
                rem = rem >> logs[q]
            E = j * k
            stored = r0 + r + b * (k + (Hj << lp))
        else:
            r, g, k = e & (R - 1), (e >> lR) & (G - 1), e >> (lR + lG)
            i3, rem, sw = torch.zeros_like(H), H, lgS
            for q in range(p + 1, len(logs)):
                sw -= logs[q]
                i3 |= (rem & ((1 << logs[q]) - 1)) << sw
                rem = rem >> logs[q]
            E = (i3 * k) << lgT
            stored = r0 + r + b * (K0 + g + (k << lgT) + (H << (lgT + lp)))
            # in place: a block stores the points it loaded
            assert torch.equal(stored.sort(1).values, loaded.sort(1).values)
        v = tile_.gather(1, (((k << lG) + g) * R + r).expand_as(tile_))
        if not last:
            assert int(E.max()) < n
            v = K.mul_plain(v, _split(tabs.tw_lo, tabs.tw_hi, tabs.h_tw, E))
        if inverse and last:
            v = K.mul_plain(v, torch.tensor(tabs.ninv))
        flat = (c * b * n + stored).reshape(-1)
        assert torch.equal(flat.sort().values, torch.arange(C * b * n))
        out[flat] = v.reshape(-1)
    return out.reshape(C, b * n), plan


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


@pytest.mark.parametrize("blowup", [1, 8])
@pytest.mark.parametrize("logn", [17, 20, 23])
def test_plans_of_the_proof_sizes(logn, blowup):
    """At 2^17, 2^20 and 2^23 points: at most two passes, each block's
    tile within the tile and the card's shared memory, with two groups or
    more where the pass has a strided side, and a grid of fewer than
    2^31 blocks at 94 columns."""
    src = open(K.os.path.join(K.CSRC, "ntt.cu")).read()
    assert f"#define NTT_TILE_LOG {K.NTT_TILE.bit_length() - 1} " in src
    plan = K.ntt_plan(1 << logn, blowup)
    assert len(plan) == 2 and sum(ps["log"] for ps in plan) == logn
    for ps in plan:
        assert ps["points"] <= K.NTT_TILE and ps["smem_bytes"] <= MAX_SMEM
        assert ps["log"] <= K.NTT_TILE.bit_length() - 2
        assert ps["log_R"] == min(blowup.bit_length() - 1, 13 - ps["log"])
        assert ps["log_G"] >= 1 or ps["log_R"] + ps["log"] == 13
        assert 94 * ps["blocks"] < 1 << 31
    assert K.ntt_plan(1 << 13, blowup)[0]["log"] == 13
