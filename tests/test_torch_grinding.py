"""Proof-of-work grinding of the port's coin (engine/coin.py) against the JAX
package's, on the CPU: above 10 bits the port searches nonces in batches
(BLAKE3 merges, Rescue digests) and must return the nonce of the JAX coin's
batched device search `_grind_device` (called as tests/test_grinding.py
calls it), whatever the batch size. BLAKE3 at 11-14 bits and Rescue at 11
and 12 are here; Rescue at 13 and 14 is in tests/test_torch_grinding_rescue.py
(the JAX Rescue search takes seconds a batch on the CPU). Tolerance: exact
equality."""
import pytest
import torch

from certificate_stark_tpu.engine import hasher as JH
from certificate_stark_tpu.engine.coin import RandomCoin as JCoin
from certificate_stark_tpu_torch.engine.coin import RandomCoin
from certificate_stark_tpu_torch.engine.hasher import get_hasher


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops: the suite runs a worker
    process per core, and more threads a worker oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _coins(hash_fn, salt):
    jh, h = JH.get_hasher(hash_fn), get_hasher(hash_fn)
    jcoin, coin = JCoin(jh, [3, 1, 4, 1, 5]), RandomCoin(h, [3, 1, 4, 1, 5])
    jcoin.reseed(jh.host_digest([9, 2, 6, salt]))
    coin.reseed(h.host_digest([9, 2, 6, salt]))
    assert coin.state == jcoin.state
    return coin, jcoin


def check_grind(hash_fn, bits):
    coin, jcoin = _coins(hash_fn, bits)
    nonce = coin.grind(bits, device="cpu")
    assert nonce == jcoin._grind_device(bits, 1 << 26, batch=1 << 12)
    assert coin.check_pow(nonce, bits)
    assert not any(coin.check_pow(n, bits) for n in range(min(nonce, 64)))


@pytest.mark.parametrize("hash_fn, bits", [("blake3", 11), ("blake3", 12),
                                           ("blake3", 13), ("blake3", 14),
                                           ("rescue", 11), ("rescue", 12)])
def test_grind_matches_jax_device_search(hash_fn, bits):
    check_grind(hash_fn, bits)


def test_batch_size_does_not_change_the_nonce():
    coin, _ = _coins("blake3", 99)
    got = {coin.grind(13, device="cpu", batch=b)
           for b in (1 << 7, 1 << 11, 1 << 15)}
    assert len(got) == 1


def test_grind_above_10_bits_needs_the_device():
    """Above 10 bits the search runs on the device the caller names, the
    card by default; it never drops to the host loop."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    coin, _ = _coins("blake3", 5)
    assert coin.grind(10) == coin.grind(10, device="cpu")   # the host loop
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coin.grind(11)
