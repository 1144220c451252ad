"""The golden `transaction_2tx_d3_sha3` (tests/vectors/torch_goldens.json):
the port's proof of the composed state-transition AIR at 2 transactions,
depth 3, with SHA3-256 commitments, reproduced byte for byte with its coin
journal and trace roots on the CPU; the JAX package's verifier and the
port's accept it and reject it with one opened value flipped. The checks
are those of tests/test_torch_sha_proofs.py. Tolerance: exact equality."""
import pytest

from test_torch_sha_proofs import (check_flipped_opening_rejected,  # noqa: F401
                                   check_golden, check_verifiers_accept,
                                   fp2_curve, one_torch_thread, prove_golden)


@pytest.fixture(scope="module")
def proven():
    return prove_golden("transaction_2tx_d3_sha3")


def test_golden_reproduced(proven):
    check_golden(proven)


def test_both_verifiers_accept(proven):
    check_verifiers_accept(proven)


def test_flipped_opening_rejected_by_both(proven):
    check_flipped_opening_rejected(proven)
