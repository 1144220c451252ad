"""The traces of the port's standalone AIR programs (range, merkle-init,
merkle-update, Schnorr) against the JAX package's, on the CPU. The
merkle-update and Schnorr traces are cuts of the plain version of the trace
kernel, held to the JAX package's host rows (`tx_rows` with the row-1
degree hack, `sig_rows`). The merkle-init trace is held to the JAX
package's host round (utils/rescue_ref.py) and, for the example's inputs,
to the SHA-256 of the JAX `build_trace` output that the golden
`merkle_init_rescue` records (the JAX function itself runs op by op and
takes minutes on the CPU). Tolerance: exact equality.

The module runs on the fp2 curve instance (the library default, which the
goldens use) in both packages."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from certificate_stark_tpu.models import merkle_init as JMI
from certificate_stark_tpu.models import merkle_update as JMU
from certificate_stark_tpu.models import range as JRG
from certificate_stark_tpu.models import schnorr as JSC
from certificate_stark_tpu.ops import field as JF
from certificate_stark_tpu.utils import curve as JCV
from certificate_stark_tpu.utils import rescue_ref as JRR
from certificate_stark_tpu_torch.engine.options import ProofOptions
from certificate_stark_tpu_torch.models import merkle_init as MI
from certificate_stark_tpu_torch.models import merkle_update as MU
from certificate_stark_tpu_torch.models import range as RG
from certificate_stark_tpu_torch.models import schnorr as SC
from certificate_stark_tpu_torch.utils import curve as CV
from certificate_stark_tpu_torch.utils import witness as W
from certificate_stark_tpu_torch.utils.convert import to_jax_limbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = JF.P
OPTS = dict(num_queries=14, blowup=8, hash_fn="blake3")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def fp2_curve():
    prev = (JCV.CURVE_NAME, CV.CURVE_NAME)
    JCV.set_curve("fp2")
    CV.set_curve("fp2")
    yield
    JCV.set_curve(prev[0])
    CV.set_curve(prev[1])


@pytest.fixture(scope="module")
def signed():
    """Five signed messages of the Schnorr example (seed 5)."""
    ex = SC.SchnorrExample(5, ProofOptions(**OPTS), device="cpu")
    return ex.messages, ex.signatures


def _limbs(rows):
    """Host rows [n][w] of standard-form ints -> JAX limbs [4, w, n]."""
    return JF.from_int(np.array(rows, dtype=object).T)


# ---- traces ---------------------------------------------------------------
@pytest.mark.parametrize("number", [0, 1, P - 1, 0x2F1C0FFEE5EED])
def test_range_trace_matches_jax(number):
    got = RG.build_trace(number, "cpu")
    assert got.shape == (RG.TRACE_WIDTH, RG.RANGE_LOG)
    assert np.array_equal(to_jax_limbs(got),
                          np.asarray(JRG.build_trace(number)))


@pytest.mark.parametrize("number", [P, -5])
def test_range_rejects_values_outside_the_field(number):
    with pytest.raises(ValueError):
        RG.build_trace(number, "cpu")
    with pytest.raises(ValueError):
        RG.RangeExample(number, ProofOptions(**OPTS), device="cpu")
    with pytest.raises(ValueError):
        JRG.build_trace(number)


def _merkle_init_rows(s_in, r_in, delta):
    """The JAX package's merkle-init trace in host ints: its `init_row`,
    then the four states advanced by its host Rescue round."""
    row = JMI.init_row(s_in, r_in, delta)
    rows = [row]
    for step in range(JMI.CYCLE - 1):
        row = list(row)
        for pos in (JMI.SENDER_INITIAL_POS, JMI.SENDER_UPDATED_POS,
                    JMI.RECEIVER_INITIAL_POS, JMI.RECEIVER_UPDATED_POS):
            row[pos:pos + 14] = JRR.apply_round(row[pos:pos + 14], step)
        rows.append(row)
    return rows


def test_merkle_init_trace_matches_jax():
    rng = np.random.default_rng(7)
    s_in = [int(v) for v in rng.integers(0, P, 14, dtype=np.uint64)]
    r_in = [int(v) for v in rng.integers(0, P, 14, dtype=np.uint64)]
    for args in (([0] * 14, [0] * 14, 1), (s_in, r_in, 12345)):
        got = MI.build_trace(*args, device="cpu")
        assert got.shape == (MI.TRACE_WIDTH, MI.CYCLE)
        assert np.array_equal(to_jax_limbs(got),
                              _limbs(_merkle_init_rows(*args)))
    # the example's trace, as the JAX package's build_trace made it
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_goldens.json")) as f:
        g = json.load(f)["merkle_init_rescue"]
    ex = MI.MerkleInitExample(ProofOptions(**g["options"]), device="cpu")
    assert hashlib.sha256(ex.trace.numpy().astype("<i8").tobytes()) \
        .hexdigest() == g["trace_sha256"]


@pytest.mark.parametrize("n_tx", [1, 5])
def test_merkle_update_trace_matches_jax_tx_rows(n_tx):
    depth = 3
    txs = W.build_random(n_tx, depth, seed=1).tx_dicts()
    rows = []
    for t in txs:
        args = (t["initial_root"], t["s_old"], t["r_old"], t["delta"],
                t["s_idx"], t["r_idx"], t["s_path"], t["r_path"], depth)
        window = JMU.tx_rows(*args)
        assert MU.tx_rows(*args) == window
        rows.extend(window)
    rows[1][MU.S_BIT] = rows[1][MU.R_BIT] = 1   # the row-1 degree hack
    got = MU.build_trace(txs, depth, "cpu")
    assert got.shape == (MU.TRACE_WIDTH, MU.CYCLE * n_tx)
    assert np.array_equal(to_jax_limbs(got), _limbs(rows))


@pytest.mark.parametrize("n_sig", [2, 5])
def test_schnorr_trace_matches_jax_sig_rows(signed, n_sig):
    messages, signatures = (x[:n_sig] for x in signed)
    rows = []
    for msg, sig in zip(messages, signatures):
        window = JSC.sig_rows(msg, sig)
        rows.extend(window)
    assert SC.sig_rows(messages[-1], signatures[-1]) == window
    got = SC.build_trace(messages, signatures, "cpu")
    assert got.shape == (SC.TRACE_WIDTH, SC.SIG_CYCLE * n_sig)
    assert np.array_equal(to_jax_limbs(got), _limbs(rows))


