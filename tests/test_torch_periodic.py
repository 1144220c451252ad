"""The port's periodic-column combinators (certificate_stark_tpu_torch/
utils/periodic.py: stitch, fill, pad) against the JAX package's copy
(certificate_stark_tpu/utils/periodic.py) on the same seeded numpy-made
columns, index maps and lengths, and on the case of
tests/test_periodic_utils.py. Both must return equal columns, update the
list they are given in the same way (the same object returned, the same
entries replaced, the inner lists they were given left as they were).
Tolerance: exact equality."""
import copy

import numpy as np
import pytest

from certificate_stark_tpu.utils import periodic as JP
from certificate_stark_tpu_torch.utils import periodic as TP

P = 4719772409484279809


def _cols(rng, n, lo, hi):
    """n lists of lo .. hi - 1 random field elements (Python ints)."""
    return [[int(v) for v in rng.integers(0, P, size=int(rng.integers(lo, hi)),
                                          dtype=np.uint64)]
            for _ in range(n)]


def _pairs(rng, n_src, n_dst, count):
    return [(int(s), int(d)) for s, d in zip(rng.integers(0, n_src, count),
                                             rng.integers(0, n_dst, count))]


def _both(fn, columns, *args):
    """fn of each package on its own deep copy of `columns`: the returned
    lists, and checks that each returns the list it was given and leaves
    the inner lists it was given unchanged."""
    out = []
    for mod in (JP, TP):
        cols = copy.deepcopy(columns)
        inner = [list(c) for c in cols]
        given = list(cols)
        got = getattr(mod, fn)(cols, *args)
        assert got is cols
        assert [list(c) for c in given] == inner
        out.append(got)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_combinators_match_the_jax_copy(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    columns = _cols(rng, n, 0, 9)
    new = _cols(rng, 4, 0, 6)
    patterns = _cols(rng, 4, 1, 6)
    length = int(rng.integers(0, 24))
    value = int(rng.integers(0, P, dtype=np.uint64))
    jax_cols, port_cols = _both("stitch", columns, new,
                                _pairs(rng, len(new), n, 5))
    assert port_cols == jax_cols
    fill_map = _pairs(rng, len(patterns), n, 4)
    jax_cols, port_cols = _both("fill", jax_cols, patterns, fill_map, length)
    assert port_cols == jax_cols
    assert all(len(port_cols[d]) >= length for _, d in fill_map)
    indices = sorted({int(i) for i in rng.integers(0, n, 3)})
    jax_cols, port_cols = _both("pad", jax_cols, indices, length + 3, value)
    assert port_cols == jax_cols
    assert all(len(port_cols[i]) >= length + 3 for i in indices)


def test_reference_case():
    """tests/test_periodic_utils.py's case through both copies."""
    for mod in (JP, TP):
        cols = [[], [1]]
        mod.stitch(cols, [[7, 8]], [(0, 0)])
        assert cols[0] == [7, 8]
        mod.fill(cols, [[2, 3]], [(0, 1)], 6)
        assert cols[1] == [1, 2, 3, 2, 3, 2]
        mod.pad(cols, [0], 5, 0)
        assert cols[0] == [7, 8, 0, 0, 0]
