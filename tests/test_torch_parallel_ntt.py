"""The port's six-step NTT over ranks (certificate_stark_tpu_torch/parallel/
ntt.py `ntt_sharded`) against the JAX package's `ops/ntt.py` `ntt` (the
reference of tests/test_parallel_ntt.py, at its n = 512) and its host
transform (the other sizes), on the CPU: eight gloo ranks
spawned once for the module (one torch thread each), the D = 4 cases on
each of two process groups of four of them, the D = 8 cases on all. Forward and
inverse transforms of seeded values at n = 512 and 1024 with batch axes,
and the round trip. Tolerance: exact equality.

The ranks import this module, so JAX is imported by the tests only."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from certificate_stark_tpu_torch.ops import field as F
from certificate_stark_tpu_torch.parallel import mesh as PM
from certificate_stark_tpu_torch.parallel import ntt as PN

# (ranks, n, batch shape)
CASES = ((4, 512, (2,)), (4, 1024, (3, 2)), (8, 512, (2,)),
         (8, 1024, (3, 2)))
JAX_DEVICE_CASE = (512, (2,))


def _values(n, batch):
    rng = np.random.default_rng(n + len(batch))
    return rng.integers(0, F.P, size=batch + (n,), dtype=np.uint64)


def _ranks(mesh):
    """Every case on its ranks -> {case: (forward, inverse, round trip)}
    as whole int64 arrays, and the error a transform that does not split
    raises."""
    torch.set_num_threads(1)
    groups = [dist.new_group(list(range(g, g + 4))) for g in (0, 4)]
    quad = PM.make_mesh("cpu", "gloo", group=groups[mesh.rank // 4])
    out = {}
    for D, n, batch in CASES:
        m = mesh if D == 8 else quad
        x = F.to_mont(torch.from_numpy(_values(n, batch).astype(np.int64)))
        lo, hi = m.rank * n // D, (m.rank + 1) * n // D
        fwd = PN.ntt_sharded(m, x[..., lo:hi], n)
        inv = PN.ntt_sharded(m, x[..., lo:hi], n, inverse=True)
        back = PN.ntt_sharded(m, fwd, n, inverse=True)
        whole = [m.all_gather(t).movedim(0, -2).reshape(batch + (n,))
                 .numpy() for t in (fwd, inv, back)]
        out[(D, n, batch)] = whole
    try:
        PN.ntt_sharded(mesh, torch.zeros(2, dtype=torch.int64), 16)
    except ValueError as e:
        out["error"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return PM.launch(_ranks, 8, "gloo", device="cpu", timeout=300)


@pytest.fixture(scope="module")
def jax_reference():
    """(n, batch) -> the JAX package's (forward, inverse) in the port's
    int64 Montgomery form: its `ops/ntt.py` `ntt` (jitted) for the case of
    tests/test_parallel_ntt.py, n = 512 over a batch of 2; its host
    transform `utils/poly_host.py` (Python ints, the reference of
    tests/test_torch_ntt.py) for the others, since XLA:CPU compiles cost
    seconds a shape."""
    import jax
    from certificate_stark_tpu.ops import field as JF, ntt as JN
    from certificate_stark_tpu.utils import poly_host as JPH
    from certificate_stark_tpu_torch.utils.convert import from_jax_limbs
    out = {}
    for n, batch in sorted({(n, b) for _, n, b in CASES}):
        vals = _values(n, batch)
        if (n, batch) == JAX_DEVICE_CASE:
            arr = JF.from_int(vals)
            fn = jax.jit(JN.ntt, static_argnums=1)
            out[(n, batch)] = [from_jax_limbs(np.asarray(fn(arr, i)))
                               .numpy() for i in (False, True)]
            continue
        rows = [[int(v) for v in row] for row in vals.reshape(-1, n)]
        out[(n, batch)] = [
            F.from_ints([tf(r) for r in rows], "cpu").reshape(batch + (n,))
            .numpy() for tf in (JPH.ntt, JPH.intt)]
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"D{c[0]}-n{c[1]}-"
                         f"{'x'.join(map(str, c[2]))}")
def test_sharded_ntt_matches_jax(ranks, jax_reference, case):
    _, n, batch = case
    fwd, inv = jax_reference[(n, batch)]
    for out in ranks:
        got_fwd, got_inv, _ = out[case]
        assert np.array_equal(got_fwd, fwd)
        assert np.array_equal(got_inv, inv)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"D{c[0]}-n{c[1]}-"
                         f"{'x'.join(map(str, c[2]))}")
def test_sharded_ntt_round_trip(ranks, case):
    _, n, batch = case
    x = F.to_mont(torch.from_numpy(_values(n, batch).astype(np.int64)))
    assert all(np.array_equal(out[case][2], x.numpy()) for out in ranks)


def test_sharded_ntt_refuses_what_does_not_split(ranks):
    # 16 = 4 x 4 points do not split over 8 ranks
    assert all("does not split over 8 ranks" in out["error"]
               for out in ranks)


@pytest.mark.parametrize("n, d", [(1 << 10, 4), (1 << 11, 8), (1 << 23, 4),
                                  (1 << 6, 8)])
def test_split_and_twiddles(n, d):
    n1, n2 = PN.split(n)
    assert n1 * n2 == n and n1 <= n2 <= 2 * n1 and PN.splits(n, d)
    if n > 1 << 12:
        return
    w = pow(F.GENERATOR, (F.P - 1) // n, F.P)
    for rank in (0, d - 1):
        tw = F.to_ints(PN.twiddles(n, d, rank, False, "cpu"))
        rows = n2 // d
        assert tw.shape == (rows, n1)
        for i in (0, rows - 1):
            i2 = rank * rows + i
            assert [int(v) for v in tw[i, :5]] == \
                [pow(w, i2 * k1, F.P) for k1 in range(5)]
