"""PDSCH receive path, per slot and slot-batched, shared with the PUSCH.

Port of python_5gtoolbox_tpu/phy/pdsch_rx.py (reference:
py5gphy/nr_pdsch/nr_pdsch_dmrs.py:139, nrpdsch_resource_mapping.py:87,
nr_pdsch.py:212-284, nr_dlsch_decode.py:13-109).

Per slot (the reference's shape, HARQ studies): H_LS_est (LS estimate on
the DMRS REs, the slot's DMRS cached on the device per slot number) ->
rx/channel_estimate.py:NrChannelEstimation -> RX_process: the data REs
gathered with one index tensor per configuration, one equalizer call
over all of them (rx/equalize.py, linear or ML), descrambling with the
device PRBS, then dlsch_decode (Er-grouped rate recovery, HARQ LLR
combining, LDPC decode, TB CRC). The received grid, the estimates and
the LLRs stay on the device; RX_process returns (ok, tbblk, llr_dns) as
tensors there.

Slot-batched: one call runs LS estimation, DFT/DCT CE, TO/FO
compensation, equalization, demod, descrambling, rate recovery, LDPC
decode and the TB CRC for a stack of slots (rx/batch_core.py). The UL-SCH
takes both paths (phy/pusch_rx.py) with Ncb = N (tbs_lbrm None) and, for
DFT-s-OFDM, the de-precode branch; the channel object gives the DMRS
sequence (dmrs_seq), the scrambling c_init (scramble_cinit) and the core
(_rx_core: the PUSCH builds its own with UCI).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import on_device
from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops import ldpc as ldpc_ops
from python_5gtoolbox_tpu_torch.ops.modulation import QM_NAME
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs, gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.pdsch import (Pdsch, get_dmrs_symlist,
                                                  pdsch_dmrs_seq)
from python_5gtoolbox_tpu_torch.rx.batch_core import (data_re_layout,
                                                      ls_estimate)
from python_5gtoolbox_tpu_torch.rx.demod import demodulate
from python_5gtoolbox_tpu_torch.rx.equalize import channel_equ_and_demod
from python_5gtoolbox_tpu_torch.utils.profiling import span


def _dmrs_scaling(ncdm: int) -> float:
    return 1.0 if ncdm == 1 else 10 ** (-3 / 20)


def dmrs_ls_est(fd_slot, cfg: dict, seqs, symlist, kind: str):
    """LS estimate of one slot: fd_slot (Nr, 14*n_sc) tensor, seqs (nsym,
    rb*6) the DMRS of each DMRS symbol on its device -> (H_LS (nsym,
    rb*3, Nr, NL), RS_info)."""
    ra, dmrs = cfg["ResAlloType1"], cfg["DMRS"]
    nl = cfg["num_of_layers"]
    ports = cfg["PortIndexList"]
    n_sc = fd_slot.shape[-1] // 14
    h_ls = ls_estimate(fd_slot[None], seqs[None], symlist, ports, nl,
                       ra["RBStart"], ra["RBSize"], n_sc,
                       _dmrs_scaling(dmrs["NumCDMGroupsWithoutData"]))[0]
    rs_info = dict(type=kind, RSSymMap=list(symlist),
                   PortIndexList=ports[:nl], RE_distance=4,
                   NumCDMGroupsWithoutData=dmrs["NumCDMGroupsWithoutData"])
    return h_ls, rs_info


def pdsch_dmrs_ls_est(fd_slot_data, pdsch_config: dict, slot: int):
    """LS channel estimate on the DMRS REs of a (Nr, 14*n_sc) slot tensor
    -> (H_LS (sym, RB*3, Nr, NL), RS_info), on the slot's device (numpy
    goes to the card)."""
    cfg = pdsch_config
    fd = on_device(fd_slot_data).to(torch.complex64)
    ra = cfg["ResAlloType1"]
    symlist = get_dmrs_symlist(cfg["StartSymbolIndex"] + cfg["NrOfSymbols"],
                               cfg["DMRS"]["DMRSAddPos"])
    seqs = torch.as_tensor(np.stack([
        pdsch_dmrs_seq(cfg["DMRS"], ra["RBStart"], ra["RBSize"], slot, sym)
        for sym in symlist]).astype(np.complex64), device=fd.device)
    return dmrs_ls_est(fd, cfg, seqs, symlist, "nr_pdsch")


def _data_usage(cfg: dict, symlist) -> np.ndarray:
    """(nsym, RB*12) int8 host map, 1 on DMRS and DMRS-reserved REs."""
    rb_size = cfg["ResAlloType1"]["RBSize"]
    ssi, nsym = cfg["StartSymbolIndex"], cfg["NrOfSymbols"]
    data_idx, _ = data_re_layout(
        tuple(cfg["PortIndexList"]), cfg["num_of_layers"],
        cfg["DMRS"]["NumCDMGroupsWithoutData"], rb_size, ssi, nsym, symlist,
        1)
    usage = np.zeros((nsym, rb_size * 12), np.int8)
    for sym in symlist:
        if ssi <= sym < ssi + nsym:
            usage[sym - ssi] = 1
            usage[sym - ssi, data_idx] = 0
    return usage


def copy_rx_pdsch_resource(rx_fd_slot, pdsch_config: dict):
    """(Nr, 14*n_sc) slot tensor -> (pdsch_resource (nsym, RB*12, Nr) on
    its device (numpy goes to the card), pdsch_RE_usage (nsym, RB*12)
    int8 host map, 1 on DMRS REs)."""
    cfg = pdsch_config
    rx = on_device(rx_fd_slot)
    ra = cfg["ResAlloType1"]
    ssi, nsym = cfg["StartSymbolIndex"], cfg["NrOfSymbols"]
    lo = ra["RBStart"] * 12
    res = rx.reshape(rx.shape[0], 14, -1)[:, ssi: ssi + nsym,
                                          lo: lo + ra["RBSize"] * 12]
    symlist = get_dmrs_symlist(ssi + nsym, cfg["DMRS"]["DMRSAddPos"])
    return res.permute(1, 2, 0).to(torch.complex64), _data_usage(cfg,
                                                                 symlist)


def sch_decode(llr: torch.Tensor, tbsize: int, qm: int, rate1024: float,
               n_layers: int, rv: int, tbs_lbrm, ldpc_cfg: dict,
               harq_on: bool = False, current_llr_dns=None):
    """DL-SCH / UL-SCH decode of one slot's (G,) descrambled LLRs ->
    (ok 0-dim bool tensor, tbblk (A,) int8, llr_dns (C, N) float32), all
    on llr's device. tbs_lbrm None means Ncb = N (UL-SCH). With harq_on
    and a previous buffer, the two are combined: averaged where both are
    nonzero, else summed."""
    G = llr.shape[-1]
    tb_poly, B, bgn, info, ncb, er_list = ldpc_ops.sch_plan(
        tbsize, rate1024, G, qm, n_layers, tbs_lbrm)
    recs, g_off = [], 0
    for c0, c1, E in ldpc_ops.er_groups(er_list):
        grp = llr[g_off: g_off + (c1 - c0) * E].reshape(c1 - c0, E)
        recs.append(ldpc_ops.ldpc_raterecover(grp, info, rv, qm, Ncb=ncb))
        g_off += (c1 - c0) * E
    llr_dns = torch.cat(recs).to(torch.float32)
    if harq_on and current_llr_dns is not None \
            and current_llr_dns.numel():
        prev = torch.as_tensor(current_llr_dns, device=llr.device)
        both = (llr_dns != 0) & (prev != 0)
        comb = llr_dns + prev
        llr_dns = torch.where(both, comb / 2, comb).to(torch.float32)
    bits, _, _ = ldpc_ops.ldpc_decode(
        llr_dns.contiguous(), info.Zc, bgn, ldpc_cfg["L"],
        algo=ldpc_cfg["algo"], alpha=ldpc_cfg["alpha"],
        beta=ldpc_cfg["beta"])
    # CB-CRC24B is stripped; as in the reference, a code block's CRC
    # failure does not abort the TB (nr_dlsch_decode.py:97-99)
    cb_bits = bits[:, : info.cbz] if info.C > 1 \
        else bits[:, : info.cbz + info.L]
    blk = cb_bits.reshape(1, -1)[:, :B]
    ok = crc_ops.crc_check(blk, tb_poly)[0] == 0
    return ok, blk[0, :tbsize], llr_dns


def dlsch_decode(llr, tbsize: int, qm: int, rate1024: float, n_layers: int,
                 rv: int, tbs_lbrm: int, ldpc_cfg: dict,
                 harq_on: bool = False, current_llr_dns=None):
    """DL-SCH decode chain -> (ok, tbblk, new_llr_dns (C, N)); LBRM
    circular buffer Ncb from tbs_lbrm. See sch_decode."""
    return sch_decode(on_device(llr).to(torch.float32), tbsize, qm,
                      rate1024, n_layers, rv, tbs_lbrm, ldpc_cfg, harq_on,
                      current_llr_dns)


def rx_core_kwargs(key: tuple) -> dict:
    """The keyword arguments of build_batch_rx_core for one static
    config key (see PdschRxMixin.rx_batch_prepare)."""
    (rb_start, rb_size, ssi, nsym, ports, nl, ncdm, add_pos, scs, n_sc,
     nr, qm, tbsize, rate1024, tbs_lbrm, rv, algo, ldpc_key, ce_key,
     scaling_db, harq, tp) = key
    return dict(
        rb_start=rb_start, rb_size=rb_size, ssi=ssi, nsym=nsym,
        ports=ports, nl=nl, ncdm=ncdm, scs=scs, n_sc=n_sc, nr=nr, qm=qm,
        tbsize=tbsize, rate1024=rate1024, tbs_lbrm=tbs_lbrm, rv=rv,
        algo=algo, ldpc_cfg=dict(zip(("L", "algo", "alpha", "beta"),
                                     ldpc_key)),
        ce_config=dict(ce_key), symlist=get_dmrs_symlist(ssi + nsym, add_pos),
        scaling=1.0 if ncdm == 1 else 10 ** (scaling_db / 20), harq=harq,
        transform_precode=tp)


@functools.lru_cache(maxsize=None)
def _batch_rx_fn(key: tuple):
    """Build the batched-RX core for one static config."""
    from python_5gtoolbox_tpu_torch.rx.batch_core import build_batch_rx_core

    kw = rx_core_kwargs(key)
    fn, G = build_batch_rx_core(**kw)
    return fn, G, kw["symlist"]


class PdschRxMixin:
    """RX methods mixed into Pdsch (phy/pdsch.py) and, through
    phy/pusch_rx.py, into NrPUSCH."""

    _RS_TYPE = "nr_pdsch"

    def H_LS_est(self, rx_fd_slot, slot):
        """LS estimate of one received slot (Nr, 14*n_sc), taken to
        self.device -> (H_LS (sym, RB*3, Nr, NL), RS_info with scs). The
        slot's DMRS is made once per slot number and kept on the
        device."""
        fd = torch.as_tensor(rx_fd_slot, device=self.device).to(
            torch.complex64)
        symlist = self._dmrs_symlist()
        key = ("dmrs_slot", int(slot))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(np.stack(
                [self.dmrs_seq(int(slot), sym) for sym in symlist]).astype(
                    np.complex64), device=self.device)
        h_ls, info = dmrs_ls_est(fd, self.cfg, self._cache[key], symlist,
                                 self._RS_TYPE)
        info["scs"] = self.carrier["scs"]
        self.H_LS, self.DMRS_info = h_ls, info
        return h_ls, info

    def _slot_rx_plan(self):
        """(DMRS usage map, data-RE symbol and RE index tensors on the
        device, descrambling sign (G,)), once per configuration."""
        key = "slot_rx_plan"
        if key not in self._cache:
            usage = _data_usage(self.cfg, self._dmrs_symlist())
            sym_idx, re_idx = np.nonzero(usage == 0)
            G = sym_idx.size * self.cfg["num_of_layers"] * self.qm
            cinit = torch.tensor(self.scramble_cinit(), device=self.device)
            sign = 1.0 - 2.0 * gen_prbs(cinit, G).to(torch.float32)
            self._cache[key] = (
                usage, torch.as_tensor(sym_idx, device=self.device),
                torch.as_tensor(re_idx, device=self.device), sign)
        return self._cache[key]

    def _slot_llr(self, rx_fd_slot, CEQ_config, H_result, cov_m,
                  nrChannelEstimation):
        """Equalized, demodulated and descrambled (G,) LLRs of one slot:
        the data REs gathered with one index tensor, one equalizer call;
        for DFT-s-OFDM the IDFT de-precode per symbol and demod with the
        equalizer's noise variance."""
        dev = self.device
        cfg = self.cfg
        ssi = cfg["StartSymbolIndex"]
        res, _ = copy_rx_pdsch_resource(
            torch.as_tensor(rx_fd_slot, device=dev), cfg)
        if nrChannelEstimation:
            res = nrChannelEstimation.process_pdsch_data(res, ssi)
        _, sym_idx, re_idx, sign = self._slot_rx_plan()
        H = torch.as_tensor(H_result, device=dev)
        cov = torch.as_tensor(cov_m, device=dev)
        y = res[sym_idx, re_idx]                             # (N, Nr)
        h = H[sym_idx + ssi, re_idx]                         # (N, Nr, NL)
        cv = cov[sym_idx + ssi, torch.div(re_idx, 12, rounding_mode="floor")]
        modtype = QM_NAME[self.qm]
        s_est, nv, _, llr = channel_equ_and_demod(y, h, cv, modtype,
                                                  CEQ_config)
        if cfg.get("nTransPrecode", 0) == 1:
            assert cfg["num_of_layers"] == 1
            m_sc = cfg["ResAlloType1"]["RBSize"] * 12
            yi = torch.fft.ifft(s_est.reshape(-1, m_sc), dim=-1) \
                * math.sqrt(m_sc)
            _, llr = demodulate(yi.reshape(-1), modtype, nv.reshape(-1))
        return llr.reshape(-1) * sign

    def RX_process(self, rx_fd_slot, slot, CEQ_config, H_result, cov_m,
                   LDPC_decoder_config, nrChannelEstimation=None,
                   HARQ_on=False, current_LLr_dns=None):
        """One received slot -> (ok 0-dim bool tensor, tbblk (A,) int8,
        llr_dns (C, N)), on self.device; (False, empty, empty) for a slot
        the configuration does not allocate. The rv is the next of the
        configuration's cycle (getnextrv), slot by slot."""
        if not self.is_active_slot(slot):
            return False, np.array([]), np.array([])
        llr = self._slot_llr(rx_fd_slot, CEQ_config, H_result, cov_m,
                             nrChannelEstimation)
        rv = self.getnextrv()
        return dlsch_decode(llr, self.tbsize, self.qm, self.rate1024,
                            self.cfg["num_of_layers"], rv, self.tbs_lbrm,
                            LDPC_decoder_config, harq_on=HARQ_on,
                            current_llr_dns=current_LLr_dns)

    def rx_process_batch(self, rx_fd_slots, slot_list, CEQ_config,
                         LDPC_decoder_config, ce_config, fetch=True,
                         rv=None, llr_prev=None, return_llr=False):
        """Slot-batched RX: (S, Nr, 14*nsc) + per-slot slot numbers ->
        (ok (S,) bool, tbblk (S, A) int8).

        The input goes to self.device. fetch=False returns the results as
        tensors on the device without waiting for them; fetch=True
        returns numpy arrays. HARQ chains: pass rv=, llr_prev= (the (S,
        C, N) buffer of the previous transmission) and return_llr=True;
        the return then gains the combined buffer, kept on the device.

        The core's inputs (the slots' DMRS and the descrambling sign,
        made on the host once per object and copied to the device) are
        the span rx.prepare; the core records the spans rx.ce, rx.gather,
        rx.equalize, rx.ratematch and rx.ldpc (utils.profiling.span).
        """
        harq = return_llr or llr_prev is not None
        dev = self.device
        with span("rx.prepare"):
            rx = torch.as_tensor(rx_fd_slots, device=dev).to(
                torch.complex64)
            cache = self._cache
            ck = ("rx", tuple(int(s) for s in slot_list),
                  CEQ_config["algo"], harq, None if rv is None else int(rv),
                  rx.shape[1],
                  tuple(sorted((k, v) for k, v in LDPC_decoder_config.items()
                               if not callable(v))),
                  tuple(sorted((k, v) for k, v in ce_config.items()
                               if isinstance(v, (int, float, str, bool)))))
            if ck not in cache:
                fn, dmrs, scr_sign = self.rx_batch_prepare(
                    rx.shape[1], slot_list, CEQ_config,
                    LDPC_decoder_config, ce_config, rv=rv, harq=harq)
                cache[ck] = (fn, torch.as_tensor(dmrs, device=dev),
                             torch.as_tensor(scr_sign, device=dev))
            fn, dmrs, scr_sign = cache[ck]
            prev = None if llr_prev is None else torch.as_tensor(
                llr_prev, device=dev)
        if harq:
            outs = fn(rx, dmrs, scr_sign, prev)
        else:
            outs = fn(rx, dmrs, scr_sign)
        ok, tbblk = outs[0] == 0, outs[1]
        if fetch:
            ok, tbblk = ok.cpu().numpy(), tbblk.cpu().numpy()
        return (ok, tbblk) + tuple(outs[2:])

    def rx_batch_prepare(self, nr, slot_list, CEQ_config,
                         LDPC_decoder_config, ce_config, rv=None,
                         harq=False):
        """Build the batched-RX core and its per-slot inputs without
        running it: nr RX antennas -> (fn, dmrs (S, nsym, rb*6)
        complex64, scr_sign (G,) float32), host arrays. The DMRS of
        every slot and symbol and the scrambling sign come from
        self.dmrs_seq and self.scramble_cinit; self.tbs_lbrm None means
        Ncb = N; cfg nTransPrecode 1 takes the de-precode branch."""
        cfg = self.cfg
        rv_eff = cfg["rv"][0] if rv is None else int(rv)
        ce_key = tuple(sorted(
            (k, v) for k, v in dict(ce_config).items()
            if k in ("CE_algo", "L_symm_left_in_ns", "L_symm_right_in_ns",
                     "eRB", "enable_TO_comp", "enable_FO_est",
                     "enable_FO_comp", "freq_intp_method",
                     "timing_intp_method")))
        ldpc_key = (LDPC_decoder_config["L"], LDPC_decoder_config["algo"],
                    float(LDPC_decoder_config["alpha"]),
                    float(LDPC_decoder_config["beta"]))
        rb_start = cfg["ResAlloType1"]["RBStart"]
        rb_size = cfg["ResAlloType1"]["RBSize"]
        key = (rb_start, rb_size, cfg["StartSymbolIndex"],
               cfg["NrOfSymbols"], tuple(cfg["PortIndexList"]),
               cfg["num_of_layers"], cfg["DMRS"]["NumCDMGroupsWithoutData"],
               cfg["DMRS"]["DMRSAddPos"], self.carrier["scs"],
               12 * self.prb_size, nr, self.qm, self.tbsize, self.rate1024,
               self.tbs_lbrm, rv_eff, CEQ_config["algo"], ldpc_key, ce_key,
               -3, harq, bool(cfg.get("nTransPrecode", 0)))
        fn, G, symlist = self._rx_core(key)
        dmrs = np.stack([
            np.stack([self.dmrs_seq(int(slot), sym) for sym in symlist])
            for slot in slot_list]).astype(np.complex64)
        cinit = self.scramble_cinit()
        scr_sign = (1.0 - 2.0 * gen_prbs_np(cinit, G)).astype(np.float32)
        return fn, dmrs, scr_sign

    def _rx_core(self, key: tuple):
        """(core, G, DMRS symbols) of a static config key."""
        return _batch_rx_fn(key)


def _attach_rx_methods():
    """Attach the receive path to Pdsch (phy/pdsch.py)."""
    for name in ("rx_process_batch", "rx_batch_prepare", "_rx_core",
                 "H_LS_est", "_slot_rx_plan", "_slot_llr", "RX_process",
                 "_RS_TYPE"):
        setattr(Pdsch, name, getattr(PdschRxMixin, name))


_attach_rx_methods()
