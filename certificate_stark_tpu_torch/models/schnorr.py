"""Schnorr signature-verification sub-AIR pieces that the composed
state-transition AIR uses: the constants, the host trace steps and the
constraint block. Counterpart of certificate_stark_tpu/models/schnorr.py
(reference src/schnorr/), without `SchnorrAir` itself.

It proves R = s*G + h*P with h the iterated Rescue hash of (R_x || message).
Registers of a 512-step signature window:

  cols 0..18  projective accumulator S = s*G     col 18  s-bit
  cols 19..37 projective accumulator h*P         col 37  h-bit
  cols 38..42 h-limb double-and-add accumulators (chunk 3..0 at 38..41)
  cols 42..56 Rescue hash state (digest 42..49, rate 49..56)

Steps 0..509: interleaved double (even) / conditional mixed add (odd) for
both scalar multiplications and the h-bit recomposition, with the 5-cycle
message hash in steps 0..39. Step 510: S + h*P with affine-x reduction.
"""
from __future__ import annotations

from ..ops import ecc as E
from ..params.data import P
from ..utils import curve as CV, ecc_ref as ER, rescue_ref as RR
from .constraints import rescue_enforce_round

TRACE_WIDTH = 56
SIG_CYCLE = 512
SCALAR_MUL_LENGTH = 510
NUM_HASH_ITER = 5
PPW, PCW, APW = 18, 6, 12


def _gen12():
    return list(CV.GEN12)


def build_sig_info(message28, signature):
    """(pkey12, s_bits, h_bits) for trace generation
    (schnorr/trace.rs:127-142)."""
    r_x, s = signature
    pkey12 = [int(v) % P for v in message28[:12]]
    s_bits = [(int(s) >> i) & 1 for i in range(256)]
    h_int = CV.h_scalar(CV.hash_message(list(r_x), message28))
    h_bits = [(h_int >> i) & 1 for i in range(256)]
    return pkey12, s_bits, h_bits


def init_sig_state(row, r_x):
    """Schnorr start state written into row[0:56] (schnorr/trace.rs:18-30)."""
    row[0:TRACE_WIDTH] = [0] * TRACE_WIDTH
    row[PCW] = 1                      # y(S) = 1
    row[PPW + 1 + PCW] = 1            # y(h.P) = 1
    row[42:48] = [int(v) % P for v in r_x]


def sig_step(row, step, message28, pkey12, s_bits, h_bits, gen12):
    """One Schnorr transition applied in place to row[0:56]
    (schnorr/trace.rs:35-122); `step` is signature-relative."""
    if step < 8 * NUM_HASH_ITER:
        rs = step % 8
        if rs < 7:
            row[42:56] = RR.apply_round(row[42:56], step)
        elif step < (NUM_HASH_ITER - 1) * 8:
            idx = step // 8
            row[49:56] = [int(v) % P for v in message28[7 * idx:7 * idx + 7]]
        else:
            row[49:56] = [0] * 7
    if step < SCALAR_MUL_LENGTH:
        real = step // 2
        chunk = 0 if real < 63 else (real - 63) // 64 + 1
        row[PPW] = s_bits[254 - real]
        row[2 * PPW + 1] = h_bits[254 - real]
        if step % 2 == 0:
            row[0:18] = ER.compute_double(row[0:18])
            row[19:37] = ER.compute_double(row[19:37])
            vp = 41 - chunk
            row[vp] = (2 * row[vp] + row[37]) % P
        else:
            if row[PPW] == 1:
                row[0:18] = ER.compute_add_mixed(row[0:18], gen12)
            if row[2 * PPW + 1] == 1:
                row[19:37] = ER.compute_add_mixed(row[19:37], pkey12)
    elif step == SCALAR_MUL_LENGTH:
        hp = list(row[19:37])
        row[PPW] = 1
        row[0:18] = ER.compute_add(row[0:18], hp)
        row[0:6] = ER.to_affine_x(row[0:18])


def evaluate_schnorr(fx, current, nxt, agg, ark0, ark1, doubling, addition,
                     digest_flags, pkey, final_flag, hash_flag, copy_hash,
                     internal):
    """Schnorr constraint block (schnorr/air.rs:394-531), aggregating into
    result slots 0..56 via `agg`. The flags are [1, B]; pkey [12, B] and
    internal [7, B] come from the composed AIR's copy registers."""
    one = fx.const(1, current)
    b3 = CV.B3_LIMBS
    gen12 = fx.embed(_gen12(), current)

    # the two scalar multiplications (S = s*G and h*P) run the same
    # doubling and conditional-add constraints: one EC block on [2, 19, B]
    cur12 = fx.stack([fx.cols(current, 0, 19), fx.cols(current, 19, 38)])
    nxt12 = fx.stack([fx.cols(nxt, 0, 19), fx.cols(nxt, 19, 38)])
    pts12 = fx.stack([fx.expand(gen12, pkey), pkey])
    dflag = doubling[None]
    aflag = addition[None]
    dbl12 = E.enforce_point_doubling(fx, cur12, nxt12, dflag, b3)
    addm12 = E.enforce_point_addition_mixed(fx, cur12, nxt12, pts12, aflag, b3)
    red = E.enforce_point_addition_reduce_x(
        fx, fx.cols(current, 0, 18), fx.cols(nxt, 0, 18),
        fx.cols(current, 19, 37), final_flag, b3)
    for i in range(19):
        agg(i, fx.add(dbl12[0, i], addm12[0, i]))
        agg(19 + i, fx.add(dbl12[1, i], addm12[1, i]))
    for i in range(18):
        agg(i, red[i])

    # h-limb accumulators (rows 38..42)
    hbit = fx.col(nxt, 37)
    for i, dflag in enumerate(digest_flags):
        vp = 41 - i
        acc = fx.sub(fx.col(nxt, vp),
                     fx.add(fx.double(fx.col(current, vp)), hbit))
        agg(vp, fx.mul(acc, fx.mul(dflag, doubling)[0]))
        # copy outside its double-and-add window
        cp = fx.sub(fx.col(current, vp), fx.col(nxt, vp))
        agg(vp, fx.mul(cp, fx.mul(fx.sub(one, dflag), doubling)[0]))
    for i in range(4):
        cp = fx.sub(fx.col(current, 38 + i), fx.col(nxt, 38 + i))
        agg(38 + i, fx.mul(cp, addition[0]))
        eq = fx.sub(fx.col(current, 38 + i), fx.col(current, 42 + i))
        agg(38 + i, fx.mul(eq, final_flag[0]))

    # hash rows (42..56)
    hcur = fx.cols(current, 42, 56)
    hnxt = fx.cols(nxt, 42, 56)
    round_c = fx.mul(rescue_enforce_round(fx, hcur, hnxt, ark0, ark1),
                     hash_flag)
    cp7 = fx.mul(fx.sub(fx.cols(current, 42, 49), fx.cols(nxt, 42, 49)),
                 copy_hash)
    rate = fx.mul(fx.sub(fx.cols(nxt, 49, 56), internal), copy_hash)
    for i in range(14):
        agg(42 + i, round_c[i])
    for i in range(7):
        agg(42 + i, cp7[i])
        agg(49 + i, rate[i])
