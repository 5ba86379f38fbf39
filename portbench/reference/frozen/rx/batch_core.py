"""Slot-batched RX core for PDSCH (DL-SCH) and PUSCH (UL-SCH, UCI).

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/rx/batch_core.py: LS estimation on DMRS
REs -> DFT/DCT CE (rx/ce_batch.py) -> TO/FO data compensation ->
equalization + demod, linear or ML (rx/equalize.py; for DFT-s-OFDM a
linear equalizer, the IDFT de-precode per symbol, then demod) -> descramble -> [UCI on PUSCH: the
38.212 6.2.7 demultiplex as gathers and the UCI decoders] -> Er-grouped
LDPC rate recovery (+ optional HARQ soft combine) -> LDPC decode (the
CUDA min-sum kernel on the card) -> TB CRC. The DL and UL callers
(phy/pdsch_rx.py, phy/pusch_rx.py) differ in their DMRS symbol schedule,
circular-buffer size (LBRM Ncb or Ncb = N) and sequences. The plan-time
part runs once in build_batch_rx_core; the returned core() is plain
tensor code batched over slots.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.frozen.ops import crc as crc_ops
from portbench.reference.frozen.ops import ldpc as ldpc_ops
from portbench.reference.frozen.ops.modulation import QM_NAME
from portbench.reference.frozen.rx import ce_batch
from portbench.reference.frozen.rx.demod import demodulate
from portbench.reference.frozen.rx.equalize import (
    LINEAR_EQUALIZERS, equalize_and_demod_traced, mmse, zf)


def data_re_layout(ports, nl: int, ncdm: int, rb_size: int, ssi: int,
                   nsym: int, symlist, qm: int):
    """(dmrs_data_idx, G) — per-DMRS-symbol data-RE indices and the
    total rate-match capacity (reference usage-map rules)."""
    if ncdm == 2:
        dmrs_map = np.ones(12, np.int8)
    else:
        dmrs_map = np.zeros(12, np.int8)
        if 1000 in ports[:nl] or 1001 in ports[:nl]:
            dmrs_map[0::2] = 1
        if 1002 in ports[:nl] or 1003 in ports[:nl]:
            dmrs_map[1::2] = 1
    dmrs_data_idx = np.nonzero(np.tile(dmrs_map, rb_size) == 0)[0]
    n_data_re = sum(
        (len(dmrs_data_idx) if (ssi + k) in symlist else rb_size * 12)
        for k in range(nsym))
    return dmrs_data_idx, qm * nl * n_data_re


def ls_estimate(fd, dm, symlist, ports, nl: int, rb_start: int,
                rb_size: int, n_sc: int, scaling: float) -> torch.Tensor:
    """LS estimate on the DMRS REs of a slot stack (strided slices, CDM
    pairs combined (d0 +- d1) / (2 scaling)): fd (S, Nr, 14*n_sc), dm (S,
    nsym, rb*6) -> H_LS (S, nsym, rb*3, Nr, NL)."""
    h_cols = []
    for idx, sym in enumerate(symlist):
        start = sym * n_sc + rb_start * 12
        cseq = dm[:, idx].conj()                            # (S, rb*6)
        per_tx = []
        for tx in range(nl):
            p0 = ports[tx] - 1000
            delta = (p0 // 2) % 2
            d0 = fd[:, :, start + delta: start + rb_size * 12: 4] \
                * cseq[:, None, 0::2]
            d1 = fd[:, :, start + delta + 2: start + rb_size * 12: 4] \
                * cseq[:, None, 1::2]
            sgn = 1.0 if p0 in (0, 2) else -1.0
            per_tx.append((d0 + sgn * d1) / (2 * scaling))
        h_cols.append(torch.stack(per_tx, dim=-1))          # (S, Nr, RE, NL)
    return torch.stack(h_cols, dim=1).transpose(2, 3)


def build_batch_rx_core(*, rb_start, rb_size, ssi, nsym, ports, nl,
                        ncdm, scs, n_sc, nr, qm, tbsize, rate1024,
                        tbs_lbrm, rv, algo, ldpc_cfg, ce_config,
                        symlist, scaling, harq=False,
                        transform_precode=False, uci_plan=None):
    """-> (core(rx (S, Nr, 14*n_sc) complex64, dmrs (S, nsym, rb*6)
    complex64, scr_sign (G,) float32[, llr_prev (S, C, N)]) ->
    (err (S,) int8, tbblk (S, A) int8[, llr_dns (S, C, N)]), G).

    harq=True returns the rate-recovered buffer, soft-combined with
    llr_prev where given (where both are nonzero the two are averaged),
    so that rv-cycled transmissions can be chained. tbs_lbrm None means
    Ncb = N (UL-SCH). transform_precode: DFT-s-OFDM, whose whole-symbol
    DFT blocks need 1 layer, no data on DMRS symbols (NumCDM 2) and a
    linear equalizer that gives per-RE symbol estimates. uci_plan (UCI on
    PUSCH): dict(ulsch_pos=, streams=[(name, positions, n_bits)]), the
    demultiplex positions of phy/pusch_rx.py:data_control_demux_maps; the
    UL-SCH is then the demuxed subset of G_ULSCH bits, and the return
    gains uci = {name: (bits (S, n_bits) int8, ok (S,) bool)}.
    """
    modtype = QM_NAME[qm]
    if transform_precode:
        assert nl == 1 and ncdm == 2, \
            "transform precoding needs 1 layer and NumCDM=2"
        assert algo in LINEAR_EQUALIZERS, \
            f"transform precoding needs a linear equalizer, got {algo}"
    dmrs_data_idx, G = data_re_layout(ports, nl, ncdm, rb_size, ssi, nsym,
                                      symlist, qm)
    g_sch = G
    if uci_plan is not None:
        raise ValueError("the frozen reference decodes no UCI")
    tb_poly, B, bgn, info, ncb, er_list = ldpc_ops.sch_plan(
        tbsize, rate1024, g_sch, qm, nl, tbs_lbrm)
    rs_info = dict(RSSymMap=list(symlist), RE_distance=4,
                   NumCDMGroupsWithoutData=ncdm, scs=scs)
    A = tbsize

    def core(fd, dm, scr_sign, llr_prev=None):
        s = fd.shape[0]
        dev = fd.device
        h_ls = ls_estimate(fd, dm, symlist, ports, nl, rb_start, rb_size,
                           n_sc, scaling)

        # ---- channel estimation
        est = ce_batch.channel_est_batch(h_ls, rs_info, ce_config)
        H, cov = est["H"], est["cov"]

        # ---- data resource copy + TO/FO compensation
        res = torch.stack([
            fd[:, :, (ssi + k) * n_sc + rb_start * 12:
               (ssi + k) * n_sc + rb_start * 12 + rb_size * 12]
            .transpose(1, 2) for k in range(nsym)], dim=1)  # (S, nsym, RE, Nr)
        res = ce_batch.comp_data_batch(
            res, ssi, scs, est["to_avg"],
            est["fo"] if est["fo_applied"] else None, ce_config)

        # ---- per-symbol data-RE selection (reference G order)
        ys, hs, cvs = [], [], []
        for k in range(nsym):
            sym = ssi + k
            if sym in symlist:
                if ncdm == 2:
                    continue
                didx = dmrs_data_idx
            else:
                didx = np.arange(rb_size * 12)
            di = torch.as_tensor(didx, device=dev)
            ys.append(res[:, k, di, :])
            hs.append(H[:, sym, di, :, :nl])
            cvs.append(cov[:, sym, di // 12, :, :])
        y = torch.cat(ys, dim=1)                            # (S, NRE, Nr)
        h = torch.cat(hs, dim=1)
        cv = torch.cat(cvs, dim=1)
        n_re = y.shape[1]
        y, h = y.reshape(s * n_re, nr), h.reshape(s * n_re, nr, nl)
        cv = cv.reshape(s * n_re, nr, nr)
        if transform_precode:
            # de-precode each symbol's Msc block; the LLRs take the noise
            # variance from before the IDFT, as the JAX core does
            fn_eq = zf if algo.startswith("ZF") else mmse
            s_est, nv = fn_eq(y, h, cv, irc=algo.endswith("IRC"))
            m_sc = rb_size * 12
            yi = torch.fft.ifft(s_est.reshape(s, n_re // m_sc, m_sc),
                                dim=-1) * math.sqrt(m_sc)
            _, llr = demodulate(yi.reshape(-1), modtype, nv.reshape(-1))
        else:
            llr = equalize_and_demod_traced(y, h, cv, modtype, algo)
        llr = llr.reshape(s, G) * scr_sign[None, :]

        # ---- data/control demultiplex + UCI decode

        # ---- de-rate-match (Er groups) -> (S, C, N)
        grps = []
        g_off = 0
        for c0, c1, E in ldpc_ops.er_groups(er_list):
            grp = llr[:, g_off: g_off + (c1 - c0) * E] \
                .reshape(s * (c1 - c0), E)
            mx = 10.0 * grp.abs().amax(dim=-1, keepdim=True)
            rec = ldpc_ops.ldpc_raterecover(grp, info, rv, qm, Ncb=ncb,
                                            max_llr=mx)
            grps.append(rec.reshape(s, c1 - c0, info.N))
            g_off += (c1 - c0) * E
        llr_dns = torch.cat(grps, dim=1)                    # (S, C, N)

        if llr_prev is not None:
            both = (llr_dns != 0) & (llr_prev != 0)
            comb = llr_dns + llr_prev
            llr_dns = torch.where(both, comb / 2, comb).to(torch.float32)

        bits, _, _ = ldpc_ops.ldpc_decode(
            llr_dns.reshape(s * info.C, info.N).contiguous(), info.Zc, bgn,
            ldpc_cfg["L"], algo=ldpc_cfg["algo"], alpha=ldpc_cfg["alpha"],
            beta=ldpc_cfg["beta"])
        bits = bits.reshape(s, info.C, -1)
        k_apo = info.cbz + info.L
        cb_bits = bits[:, :, : info.cbz] if info.C > 1 \
            else bits[:, :, : k_apo]
        tbblkandcrc = cb_bits.reshape(s, -1)[:, :B]
        err = crc_ops.crc_check(tbblkandcrc, tb_poly)
        outs = (err, tbblkandcrc[:, :A])
        if harq:
            outs += (llr_dns,)
        return outs

    return core, G
