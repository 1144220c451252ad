"""Python-int Rescue63 (a copy of certificate_stark_tpu/utils/rescue_ref.py,
after the reference's src/utils/rescue.rs). The Fiat-Shamir coin, the
rescue-chain trace builder and the witness (account tree, Schnorr message
hash) use it on the host."""
from __future__ import annotations

from operator import mul

from ..params import data as D

P = D.P
STATE_WIDTH = 14
RATE_WIDTH = 7
DIGEST_SIZE = 7
NUM_ROUNDS = 7


_MDS_ROWS = [D.RESCUE_MDS[i * 14:(i + 1) * 14] for i in range(14)]


def _mds_apply(state):
    return [sum(map(mul, row, state)) % P for row in _MDS_ROWS]


def apply_round(state, step):
    ark = D.RESCUE_ARK[step % 8]
    state = [pow(x, 3, P) for x in state]
    state = _mds_apply(state)
    state = [(x + ark[i]) % P for i, x in enumerate(state)]
    state = [pow(x, D.INV_ALPHA, P) for x in state]
    state = _mds_apply(state)
    state = [(x + ark[STATE_WIDTH + i]) % P for i, x in enumerate(state)]
    return state


def permutation(state):
    for r in range(NUM_ROUNDS):
        state = apply_round(state, r)
    return state


def digest(elements):
    """Sponge without padding; a trailing partial chunk still permutes."""
    state = [0] * STATE_WIDTH
    i = 0
    for e in elements:
        state[i] = (state[i] + e) % P
        i += 1
        if i % RATE_WIDTH == 0:
            state = permutation(state)
            i = 0
    if i > 0:
        state = permutation(state)
    return state[:DIGEST_SIZE]


def merge(d0, d1):
    """2-to-1 merge of full 7-element digests: perm(d0 || d1)[0..7] (the
    account tree and the Schnorr message hash)."""
    return permutation(list(d0) + list(d1))[:DIGEST_SIZE]


def merge4(d0, d1):
    """Truncated-digest merge: d0 -> state[0:4], d1 -> state[7:11]."""
    state = [0] * STATE_WIDTH
    state[0:4] = [int(x) % P for x in d0]
    state[7:11] = [int(x) % P for x in d1]
    state = permutation(state)
    return state[:4]
