"""Slot-batched RX core for PDSCH (DL-SCH) and PUSCH (UL-SCH, UCI).

Port of python_5gtoolbox_tpu/rx/batch_core.py: LS estimation on DMRS
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

from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops import ldpc as ldpc_ops
from python_5gtoolbox_tpu_torch.ops import polar as polar_ops
from python_5gtoolbox_tpu_torch.ops import smallblock as sb_ops
from python_5gtoolbox_tpu_torch.ops.modulation import QM_NAME
from python_5gtoolbox_tpu_torch.ops.polar.segment import polar_cb_segment
from python_5gtoolbox_tpu_torch.rx import ce_batch
from python_5gtoolbox_tpu_torch.rx.demod import demodulate
from python_5gtoolbox_tpu_torch.rx.equalize import (
    LINEAR_EQUALIZERS, equalize_and_demod_traced, mmse, zf)
from python_5gtoolbox_tpu_torch.utils import profiling


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


def make_uci_decoder(n_bits: int, e_uci: int, qm: int,
                     llr_limit: float = 20.0):
    """A decoder of one UCI stream: (S, E) LLRs -> (bits (S, n_bits)
    int8, ok (S,) bool). Up to 2 bits the ML correlation with the special
    tables (placeholders contribute nothing), 3-11 bits the Reed-Muller ML
    decode, above 11 bits CA-SCL polar (L 8, nMax 10, iIL 0, iBIL 1) with
    the encode side's segmentation. ok is the CRC of each polar block,
    True for the small-block codes (ML has no CRC). llr_limit is the
    shortening LLR of the polar rate recovery.

    Where a profiler is open (utils.profiling) a small-block decode is the
    span rx.uci.smallblock, a polar one (rate recovery and SCL) the span
    rx.uci.polar, which counts polar_blocks (rows times code blocks, a
    host integer) and uci_crc_fail (the blocks whose CRC failed, summed
    where the LLRs lie)."""
    if n_bits <= 2:
        cb = sb_ops.special_codebook(n_bits, qm)
        n_sb = cb.shape[1]                 # the special table's length
        msgs = ((np.arange(2 ** n_bits)[:, None] >> np.arange(n_bits)) & 1
                ).astype(np.int8)

        def fn(llr):
            with profiling.span("rx.uci.smallblock"):
                acc = sb_ops.raterecover_smallblock(llr, n_sb)
                best = torch.argmax(
                    acc @ torch.as_tensor(cb, device=llr.device).T, dim=-1)
                bits = torch.as_tensor(msgs, device=llr.device)[best]
                return bits, torch.ones(llr.shape[0], dtype=torch.bool,
                                        device=llr.device)
        return fn
    if n_bits <= 11:
        def fn(llr):
            with profiling.span("rx.uci.smallblock"):
                acc = sb_ops.raterecover_smallblock(llr, 32)
                return sb_ops.decode_smallblock(acc, n_bits), torch.ones(
                    llr.shape[0], dtype=torch.bool, device=llr.device)
        return fn

    cbs, C, er = polar_cb_segment(np.zeros(n_bits, np.int8), e_uci)
    K = cbs.shape[1]
    crc_len = 6 if (C == 1 and n_bits <= 19) else 11
    N, _ = polar_ops.gen_n_value(K, er, 10)

    def fn(llr):
        with profiling.span("rx.uci.polar"):
            outs, oks = [], None
            for m in range(C):
                rec = polar_ops.polar_raterecover(
                    llr[:, m * er:(m + 1) * er], K, N, 1, llr_limit)
                ck, ok = polar_ops.polar_decode_scl(rec, er, K, 8, 10, 0,
                                                    crc_len=crc_len)
                outs.append(ck[:, : K - crc_len])
                if profiling.active() is not None:
                    profiling.count("uci_crc_fail", ~ok)
                oks = ok if oks is None else (oks & ok)
            profiling.count("polar_blocks", llr.shape[0] * C)
            bits = torch.cat(outs, dim=1)
            if C == 2 and n_bits % 2 == 1:
                bits = bits[:, 1:]             # drop the front zero pad
            return bits, oks
    return fn


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
    uci_decs = []
    if uci_plan is not None:
        g_sch = int(uci_plan["ulsch_pos"].size)
        uci_decs = [(name, np.asarray(pos, np.int64),
                     make_uci_decoder(n_bits, int(pos.size), qm))
                    for name, pos, n_bits in uci_plan["streams"]]
    tb_poly, B, bgn, info, ncb, er_list = ldpc_ops.sch_plan(
        tbsize, rate1024, g_sch, qm, nl, tbs_lbrm)
    rs_info = dict(RSSymMap=list(symlist), RE_distance=4,
                   NumCDMGroupsWithoutData=ncdm, scs=scs)
    A = tbsize

    def core(fd, dm, scr_sign, llr_prev=None):
        s = fd.shape[0]
        dev = fd.device
        # ---- channel estimation
        with profiling.span("rx.ce"):
            h_ls = ls_estimate(fd, dm, symlist, ports, nl, rb_start,
                               rb_size, n_sc, scaling)
            est = ce_batch.channel_est_batch(h_ls, rs_info, ce_config)
            H, cov = est["H"], est["cov"]

        with profiling.span("rx.gather"):
            # ---- data resource copy + TO/FO compensation
            res = torch.stack([
                fd[:, :, (ssi + k) * n_sc + rb_start * 12:
                   (ssi + k) * n_sc + rb_start * 12 + rb_size * 12]
                .transpose(1, 2) for k in range(nsym)],
                dim=1)                                  # (S, nsym, RE, Nr)
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
            y = torch.cat(ys, dim=1)                        # (S, NRE, Nr)
            h = torch.cat(hs, dim=1)
            cv = torch.cat(cvs, dim=1)

        # ---- equalization, demodulation, descrambling
        with profiling.span("rx.equalize"):
            n_re = y.shape[1]
            y, h = y.reshape(s * n_re, nr), h.reshape(s * n_re, nr, nl)
            cv = cv.reshape(s * n_re, nr, nr)
            if transform_precode:
                # de-precode each symbol's Msc block; the LLRs take the
                # noise variance from before the IDFT, as the JAX core does
                fn_eq = zf if algo.startswith("ZF") else mmse
                s_est, nv = fn_eq(y, h, cv, irc=algo.endswith("IRC"))
                m_sc = rb_size * 12
                yi = torch.fft.ifft(s_est.reshape(s, n_re // m_sc, m_sc),
                                    dim=-1) * math.sqrt(m_sc)
                _, llr = demodulate(yi.reshape(-1), modtype,
                                    nv.reshape(-1))
            else:
                llr = equalize_and_demod_traced(y, h, cv, modtype, algo)
            llr = llr.reshape(s, G) * scr_sign[None, :]

        with profiling.span("rx.ratematch"):
            # ---- data/control demultiplex + UCI decode
            uci = {}
            if uci_plan is not None:
                for name, pos, dec in uci_decs:
                    uci[name] = dec(llr[:, torch.as_tensor(pos, device=dev)])
                llr = llr[:, torch.as_tensor(uci_plan["ulsch_pos"],
                                             device=dev)]

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
            llr_dns = torch.cat(grps, dim=1)                # (S, C, N)

            if llr_prev is not None:
                both = (llr_dns != 0) & (llr_prev != 0)
                comb = llr_dns + llr_prev
                llr_dns = torch.where(both, comb / 2, comb).to(torch.float32)

        # ---- LDPC decode (its iterations counted where a profiler is
        # open and the card's kernels decode) -> TB CRC
        with profiling.span("rx.ldpc", items=s * info.C, unit="cw"):
            iters = None
            if profiling.active() is not None and dev.type == "cuda" \
                    and ldpc_cfg["algo"] != "BP":
                iters = torch.empty(s * info.C, dtype=torch.int32,
                                    device=dev)
            bits, _, _ = ldpc_ops.ldpc_decode(
                llr_dns.reshape(s * info.C, info.N).contiguous(), info.Zc,
                bgn, ldpc_cfg["L"], algo=ldpc_cfg["algo"],
                alpha=ldpc_cfg["alpha"], beta=ldpc_cfg["beta"],
                iters_out=iters)
            if iters is not None:
                profiling.count("ldpc_iterations", iters)
            bits = bits.reshape(s, info.C, -1)
            k_apo = info.cbz + info.L
            cb_bits = bits[:, :, : info.cbz] if info.C > 1 \
                else bits[:, :, : k_apo]
            tbblkandcrc = cb_bits.reshape(s, -1)[:, :B]
            err = crc_ops.crc_check(tbblkandcrc, tb_poly)
        outs = (err, tbblkandcrc[:, :A])
        if harq:
            outs += (llr_dns,)
        return outs + (uci,) if uci_plan is not None else outs

    return core, G
