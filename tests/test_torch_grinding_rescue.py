"""Proof-of-work grinding of the port's coin with Rescue at 13 and 14 bits
(tests/test_torch_grinding.py has the other cases): above 10 bits the port
tests a batch of nonces with one Rescue digest (ops/rescue.py) and must
return the nonce of the JAX coin's `_grind_device`, on the CPU. Tolerance:
exact equality."""
import pytest

from test_torch_grinding import check_grind, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("bits", [13, 14])
def test_rescue_grind_matches_jax_device_search(bits):
    check_grind("rescue", bits)
