"""Merkle-update sub-AIR pieces that the composed state-transition AIR uses:
the register map, the host trace step and the constraint blocks.
Counterpart of certificate_stark_tpu/models/merkle_update.py (reference
src/merkle/update/), without `MerkleUpdateAir` itself.

Register map (src/merkle/constants.rs:31-63):
  0..14  sender old-path hash state     14      sender index bit
  15..29 sender new-path hash state     29..43  receiver old-path hash state
  43     receiver index bit             44..58  receiver new-path hash state
  58..65 previous-root carry
Constraint slots: 0..58 auth clusters (with the sender/receiver bit at
14/43), 58..65 root carry, 65..90 key/nonce copies, 90 balance, 91 sender
nonce, 92..99 intermediate-root equality, 99..106 previous-root match.
"""
from __future__ import annotations

from ..utils import rescue_ref as RR
from .constraints import rescue_enforce_round

TRACE_WIDTH = 65
CYCLE = 512
S_INIT, S_BIT, S_UPD = 0, 14, 15
R_INIT, R_BIT, R_UPD = 29, 43, 44
PREV_ROOT = 58


def hash_length(depth):
    return 8 * depth + 7


def _auth_update(row, base, step, index, path):
    """One step of a cluster pair's authentication-path hash, in place on a
    host row of ints (update/trace.rs:96-136)."""
    cyc, pos = divmod(step, 8)
    if pos < 7:
        row[base:base + 14] = RR.apply_round(row[base:base + 14], step)
        row[base + 15:base + 29] = RR.apply_round(row[base + 15:base + 29],
                                                  step)
    elif pos == 7:
        node = list(path[cyc + 1])
        bit = (index >> cyc) & 1
        if bit == 0:
            row[base + 7:base + 14] = node
            row[base + 15 + 7:base + 15 + 14] = node
        else:
            row[base + 7:base + 14] = row[base:base + 7]
            row[base + 15 + 7:base + 15 + 14] = row[base + 15:base + 15 + 7]
            row[base:base + 7] = node
            row[base + 15:base + 15 + 7] = node
        row[base + 14] = bit


def evaluate_setup_values(fx, current, agg, setup):
    """Key/balance/nonce value constraints at transaction setup
    (update/air.rs:84-134); result slots 65..92. setup: [1, B]."""
    s_keys = fx.mul(fx.sub(fx.cols(current, S_INIT, S_INIT + 12),
                           fx.cols(current, S_UPD, S_UPD + 12)), setup)
    r_keys = fx.mul(fx.sub(fx.cols(current, R_INIT, R_INIT + 12),
                           fx.cols(current, R_UPD, R_UPD + 12)), setup)
    for i in range(12):
        agg(65 + i, s_keys[i])
        agg(65 + 12 + i, r_keys[i])
    agg(89, fx.mul(fx.sub(fx.col(current, R_INIT + 13),
                          fx.col(current, R_UPD + 13)), setup[0]))
    bal = fx.sub(fx.sub(fx.col(current, S_INIT + 12),
                        fx.col(current, S_UPD + 12)),
                 fx.sub(fx.col(current, R_UPD + 12),
                        fx.col(current, R_INIT + 12)))
    agg(90, fx.mul(bal, setup[0]))
    nonce = fx.sub(fx.col(current, S_UPD + 13),
                   fx.add(fx.col(current, S_INIT + 13),
                          fx.const(1, current)))
    agg(91, fx.mul(nonce, setup[0]))


def evaluate_merkle_auth(fx, current, nxt, agg, ark0, ark1, tx_hash,
                         hash_input, finish, hash_flag):
    """Merkle authentication-path constraints (update/air.rs:215-369);
    result slots 0..65 and 92..106. The flags are [1, B]."""
    one = fx.const(1, current)
    not_finish = fx.sub(one, finish)
    not_input = fx.sub(one, fx.add(hash_flag, hash_input))
    copy_flag = fx.mul(tx_hash, not_input)
    init_flag = fx.mul(tx_hash, hash_input)

    # auth clusters (sender at 0/15 -> res 0..29; receiver at 29/44 -> 29..58)
    for res_base, tr_base, bit_pos in ((0, S_INIT, S_BIT), (29, R_INIT, R_BIT)):
        bit_el = fx.col(nxt, bit_pos)
        bit = bit_el[None]
        not_bit = fx.sub(one, bit)
        agg(res_base + 14, fx.mul(
            fx.sub(fx.mul(bit_el, bit_el), bit_el), tx_hash[0]))
        for roff, reg in ((0, tr_base), (15, tr_base + 15)):
            cur14 = fx.cols(current, reg, reg + 14)
            nxt14 = fx.cols(nxt, reg, reg + 14)
            round_c = fx.mul(rescue_enforce_round(fx, cur14, nxt14, ark0,
                                                  ark1), hash_flag)
            for i in range(14):
                agg(res_base + roff + i, round_c[i])
            cp = fx.mul(fx.sub(fx.cols(current, reg, reg + 7),
                               fx.cols(nxt, reg, reg + 7)), copy_flag)
            ini = fx.mul(fx.mul(fx.sub(fx.cols(current, reg, reg + 7),
                                       fx.cols(nxt, reg, reg + 7)), not_bit),
                         init_flag)
            mv = fx.mul(fx.mul(fx.sub(fx.cols(current, reg, reg + 7),
                                      fx.cols(nxt, reg + 7, reg + 14)), bit),
                        init_flag)
            for i in range(7):
                agg(res_base + roff + i, fx.add(cp[i], ini[i]))
                agg(res_base + roff + 7 + i, mv[i])
        # same-sibling constraints between old/new clusters
        sib_lo = fx.mul(fx.mul(fx.sub(fx.cols(nxt, tr_base + 15, tr_base + 22),
                                      fx.cols(nxt, tr_base, tr_base + 7)), bit),
                        init_flag)
        sib_hi = fx.mul(fx.mul(fx.sub(fx.cols(nxt, tr_base + 22, tr_base + 29),
                                      fx.cols(nxt, tr_base + 7, tr_base + 14)),
                               not_bit), init_flag)
        for i in range(7):
            agg(res_base + i, sib_lo[i])
            agg(res_base + 7 + i, sib_hi[i])

    # previous-root carry (res 58..65)
    keep = fx.mul(fx.sub(fx.cols(nxt, PREV_ROOT, PREV_ROOT + 7),
                         fx.cols(current, PREV_ROOT, PREV_ROOT + 7)), not_finish)
    load = fx.mul(fx.sub(fx.cols(nxt, PREV_ROOT, PREV_ROOT + 7),
                         fx.cols(nxt, R_UPD, R_UPD + 7)), finish)
    for i in range(7):
        agg(58 + i, fx.add(keep[i], load[i]))

    # intermediate-root equality (92..99) / prev-root match (99..106)
    int_eq = fx.mul(fx.sub(fx.cols(current, S_UPD, S_UPD + 7),
                           fx.cols(current, R_INIT, R_INIT + 7)), finish)
    pm = fx.mul(fx.sub(fx.cols(nxt, S_INIT, S_INIT + 7),
                       fx.cols(current, PREV_ROOT, PREV_ROOT + 7)), finish)
    for i in range(7):
        agg(92 + i, int_eq[i])
        agg(99 + i, pm[i])
