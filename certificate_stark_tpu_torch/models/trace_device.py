"""The composed AIR's trace on the device.

Counterpart of certificate_stark_tpu/models/trace_device.py
`build_trace_device`: the witness is packed on the host into per-transaction
input tensors (`pack_witness`) and the trace kernel (csrc/tx_trace.cu,
ops/kernels.py `transaction_trace`) builds the Montgomery trace
[94, 1024*T], one thread block per transaction. The standalone Schnorr
and merkle-update traces (`build_trace_sig`, `build_trace_mu`; JAX
`build_trace_device_sig`/`_mu`) are column and row cuts of its output.

`build_trace_plain` is that kernel's plain PyTorch version, a port of
certificate_stark_tpu/models/trace_np.py `build_trace_np`: one step loop
that advances all T transaction windows at once on a state [94, T].
"""
from __future__ import annotations

import torch

from ..engine.fieldops import BASE
from ..ops import ecc as E, field as F, kernels as K, rescue as R
from ..utils import curve as CV
from . import merkle_update as MU
from . import schnorr as SC
from . import transaction as TX


_BITS = ("path_bits", "sbits", "hbits", "dbits", "gbits")


def _tensors(rows, device):
    """Per-input host rows -> the tensors of TRACE_INPUTS: Montgomery field
    values, 0/1 bits as int64."""
    return {name: (torch.tensor(v, dtype=torch.int64, device=device)
                   if name in _BITS else F.from_ints(v, device))
            for name, v in rows.items()}


def _consts(device):
    mds, _, ark = R.tables(device)
    return dict(gen12=F.from_ints(SC._gen12(), device),
                b3=F.from_ints(CV.B3_LIMBS, device), mds=mds, ark=ark)


def _zeros(T, depth, names, device):
    """Zero inputs of TRACE_INPUTS for the lanes a sub-trace never reads."""
    return {name: torch.zeros((T,) + tuple(depth if s == "d" else s
                                           for s in shape),
                              dtype=torch.int64, device=device)
            for name, shape in K.TRACE_INPUTS if name in names}


def _sig_rows(messages, signatures):
    """The Schnorr lanes' host rows: pkey, rx, sbits, hbits, msg."""
    rows = {name: [] for name in ("pkey", "rx", "sbits", "hbits", "msg")}
    for msg, sig in zip(messages, signatures):
        pk, s_bits, h_bits = SC.build_sig_info(msg, sig)
        rows["pkey"].append(pk)
        rows["rx"].append([int(v) % F.P for v in sig[0]])
        rows["sbits"].append(s_bits)
        rows["hbits"].append(h_bits)
        rows["msg"].append([[int(v) % F.P for v in msg[7 * k:7 * k + 7]]
                            for k in range(4)])
    return rows


def _merkle_rows(txs, depth):
    """The Merkle lane's host rows: init, sibs, path_bits."""
    rows = {name: [] for name in ("init", "sibs", "path_bits")}
    for t in txs:
        rows["init"].append(TX.init_row(t))
        rows["sibs"].append([[list(t[key][lvl + 1]) for lvl in range(depth)]
                             for key in ("s_path", "r_path")])
        rows["path_bits"].append([[(t[key] >> lvl) & 1
                                   for lvl in range(depth)]
                                  for key in ("s_idx", "r_idx")])
    return rows


def pack_witness(md, messages, device):
    """TxMetadata + messages -> (inputs, consts) of ops/kernels.py
    `transaction_trace`."""
    txs = md.tx_dicts()
    rows = _merkle_rows(txs, md.depth)
    rows.update(_sig_rows(messages, md.signatures))
    rows["dbits"] = [[(t["delta"] >> i) & 1 for i in range(64)] for t in txs]
    rows["gbits"] = [[(((t["s_old"][12] - t["delta"]) % F.P) >> i) & 1
                      for i in range(64)] for t in txs]
    return _tensors(rows, device), _consts(device)


def select_transactions(inputs, idx):
    """The packed inputs of the transactions at positions `idx` (a list),
    in that order. A transaction's 1024 trace rows depend only on its own
    inputs, so the trace of the selection is those transactions' row
    blocks of the whole trace."""
    at = torch.tensor(idx, dtype=torch.int64, device=inputs["init"].device)
    return {name: t.index_select(0, at) for name, t in inputs.items()}


def _run(inputs, consts, depth) -> torch.Tensor:
    """The trace kernel on the card; its plain version on the CPU or inside
    `kernels.plain_versions()`."""
    if K.use_plain(inputs["init"]):
        return build_trace_plain(inputs, consts, depth)
    return K.transaction_trace(inputs, consts, depth)


def build_trace(md, messages, device) -> torch.Tensor:
    """The Montgomery trace [94, 1024*T] on `device`."""
    inputs, consts = pack_witness(md, messages, device)
    return _run(inputs, consts, md.depth)


# The standalone Schnorr (56 columns) and merkle-update (65 columns)
# register maps are exact column subsets of the composed window
# (constants.rs shares the maps), so their traces are cuts of the trace
# kernel's output, with zero inputs for the lanes they do not read.
def pack_sig(messages, signatures, device):
    """(inputs, consts) of `transaction_trace` at depth 1 for the standalone
    Schnorr trace: the Schnorr lanes' inputs, zeros for the others."""
    inputs = _tensors(_sig_rows(messages, signatures), device)
    inputs.update(_zeros(len(signatures), 1, ("init", "sibs", "path_bits",
                                              "dbits", "gbits"), device))
    return inputs, _consts(device)


def build_trace_sig(messages, signatures, device) -> torch.Tensor:
    """Standalone Schnorr trace [56, 512*N]: columns 0..55 of rows
    512..1023 of each composed window (the composed AIR's step 511 zeroes
    columns 0..57 before the Schnorr window starts, so the Merkle half
    never reaches them). Equal to schnorr.sig_rows."""
    T = len(signatures)
    out = _run(*pack_sig(messages, signatures, device), 1)
    return out.view(TX.TRACE_WIDTH, T, TX.CYCLE)[:SC.TRACE_WIDTH, :, 512:] \
        .reshape(SC.TRACE_WIDTH, T * SC.SIG_CYCLE)


def pack_mu(txs, depth, device):
    """(inputs, consts) of `transaction_trace` for the standalone
    merkle-update trace: the Merkle lane's inputs, zeros for the others."""
    inputs = _tensors(_merkle_rows(txs, depth), device)
    inputs.update(_zeros(len(txs), depth, ("pkey", "rx", "sbits", "hbits",
                                           "msg", "dbits", "gbits"), device))
    return inputs, _consts(device)


def build_trace_mu(txs, depth, device) -> torch.Tensor:
    """Standalone merkle-update trace [65, 512*T]: columns 0..64 of rows
    0..511 of each composed window, with the index-bit registers set to
    one at global row 1 (update/prover.rs:72-77). Equal to
    merkle_update.tx_rows plus that hack."""
    T = len(txs)
    out = _run(*pack_mu(txs, depth, device), depth)
    out = out.view(TX.TRACE_WIDTH, T, TX.CYCLE)[:MU.TRACE_WIDTH, :, :512] \
        .reshape(MU.TRACE_WIDTH, T * MU.CYCLE)
    out[[MU.S_BIT, MU.R_BIT], 1] = F.const(1, device)
    return out


def _rescue_round(st, r, mds, ark):
    """One Rescue round on stacked states [..., 14, T]."""
    def mds_apply(s):
        return F.mul_sum(mds[:, :, None], s[..., None, :, :], dim=-2)
    st = F.add(mds_apply(R.sbox(st)), ark[r, :14, None])
    st = F.pow_const(st, R.INV_ALPHA)
    return F.add(mds_apply(st), ark[r, 14:, None])


def build_trace_plain(inputs, consts, depth) -> torch.Tensor:
    """Plain PyTorch version of the trace kernel: the step loop of
    models/trace_np.py over a Montgomery state [94, T]."""
    thl = TX.hash_length(depth)
    init = inputs["init"]
    dev, T = init.device, init.shape[0]
    one = F.const(1, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    mds, ark = consts["mds"], consts["ark"]
    b3 = [int(v) for v in F.to_ints(consts["b3"])]
    # the two scalar multiplications' fixed points, [2, 12, T]
    points = torch.stack([consts["gen12"][:, None].expand(12, T),
                          inputs["pkey"].T])
    sibs, path_bits = inputs["sibs"], inputs["path_bits"]

    def bit_mont(bits):                        # 0/1 [T] -> Montgomery [T]
        return torch.where(bits != 0, one, zero)

    def inject(st, base, sib, bit):
        """Sibling injection for one cluster pair (update/trace.rs:96-136)."""
        b = bit != 0
        for reg in (base, base + 15):
            digest = st[reg:reg + 7].clone()
            st[reg + 7:reg + 14] = torch.where(b, digest, sib)
            st[reg:reg + 7] = torch.where(b, sib, digest)
        st[base + 14] = bit_mont(bit)

    clusters = [MU.S_INIT, MU.S_UPD, MU.R_INIT, MU.R_UPD]
    state = init.T.clone()                                   # [94, T]
    out = torch.empty((TX.TRACE_WIDTH, T, TX.CYCLE), dtype=torch.int64,
                      device=dev)
    out[:, :, 0] = state
    for step in range(TX.CYCLE - 1):
        if step < 511:
            if step < thl:
                cyc, pos = divmod(step, 8)
                if pos < 7:
                    stk = _rescue_round(torch.stack(
                        [state[c:c + 14] for c in clusters]), pos, mds, ark)
                    for i, c in enumerate(clusters):
                        state[c:c + 14] = stk[i]
                else:
                    for side, base in enumerate((MU.S_INIT, MU.R_INIT)):
                        inject(state, base, sibs[:, side, cyc].T,
                               path_bits[:, side, cyc])
            if step == thl - 1:
                state[MU.PREV_ROOT:MU.PREV_ROOT + 7] = \
                    state[MU.R_UPD:MU.R_UPD + 7]
        elif step == 511:
            state[0:58] = 0
            state[SC.PCW] = one
            state[SC.PPW + 1 + SC.PCW] = one
            state[42:48] = inputs["rx"].T
            state[TX.SIGMA_BIT] = 0
            state[TX.SIGMA_ACC] = 0
        else:
            sstep = step - 512
            # hash lane: cols 42..56
            if sstep < 40:
                pos = sstep % 8
                if pos < 7:
                    state[42:56] = _rescue_round(state[42:56], pos, mds, ark)
                elif sstep < 32:
                    state[49:56] = inputs["msg"][:, sstep // 8].T
                else:
                    state[49:56] = 0
            # scalar-mul lane: cols 0..42
            if sstep < SC.SCALAR_MUL_LENGTH:
                real = sstep // 2
                chunk = 0 if real < 63 else (real - 63) // 64 + 1
                sb = inputs["sbits"][:, 254 - real]
                hb = inputs["hbits"][:, 254 - real]
                state[SC.PPW] = bit_mont(sb)
                state[2 * SC.PPW + 1] = bit_mont(hb)
                if sstep % 2 == 0:
                    pts = torch.stack([state[0:18], state[19:37]])
                    dbl = E.compute_double(BASE, pts, b3)
                    state[0:18] = dbl[0]
                    state[19:37] = dbl[1]
                    vp = 41 - chunk
                    state[vp] = F.add(F.double(state[vp]), state[37])
                else:
                    pts = torch.stack([state[0:18], state[19:37]])
                    added = E.compute_add_mixed(BASE, pts, points, b3)
                    state[0:18] = torch.where(sb != 0, added[0], state[0:18])
                    state[19:37] = torch.where(hb != 0, added[1],
                                               state[19:37])
            elif sstep == SC.SCALAR_MUL_LENGTH:
                hp = state[19:37].clone()
                state[SC.PPW] = one
                state[0:18] = E.compute_add(BASE, state[0:18], hp, b3)
                zinv = E.f6_inv(BASE, state[12:18])
                state[0:6] = E.f6_mul(BASE, state[0:6], zinv)
            # range lanes: cols 56/57 (delta), 92/93 (sigma)
            if sstep < TX.RANGE_LOG:
                for bit_pos, acc_pos, key in ((TX.DELTA_BIT, TX.DELTA_ACC,
                                               "dbits"),
                                              (TX.SIGMA_BIT, TX.SIGMA_ACC,
                                               "gbits")):
                    state[bit_pos] = bit_mont(
                        inputs[key][:, TX.RANGE_LOG - 1 - sstep])
                    state[acc_pos] = F.add(F.double(state[acc_pos]),
                                           state[bit_pos])
        out[:, :, step + 1] = state
    return out.reshape(TX.TRACE_WIDTH, T * TX.CYCLE)
