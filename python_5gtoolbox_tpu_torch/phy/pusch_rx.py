"""PUSCH receive path (UL-SCH, CP-OFDM and DFT-s-OFDM, UCI on PUSCH), per
slot and slot-batched, and the UCI demultiplex and decoders.

Port of python_5gtoolbox_tpu/phy/pusch_rx.py (reference:
py5gphy/nr_pusch/nrpusch_resource_mapping.py:74, nr_pusch_dmrs.py:107,
nr_pusch_datactrl_multiplex.py:269, nr_ulsch_decode.py:13,
nr_pusch_uci_decode.py:19, nr_pusch.py:116-216). The PDSCH's RX methods
(phy/pdsch_rx.py) serve both links, with NrPUSCH.tbs_lbrm None and the
DMRS from NrPUSCH.dmrs_seq (PRBS, or low-PAPR per slot and symbol).

Per slot: H_LS_est and the equalized, descrambled LLRs come from the
shared mixin (for DFT-s-OFDM with the IDFT de-precode and a second demod
inside); RX_process then separates the UL-SCH and the UCI streams by the
38.212 6.2.7 demultiplex gathers (positions cached per configuration),
decodes each UCI stream (decode_uci_on_ulsch) and the UL-SCH
(ulsch_decode, HARQ combining as on the DL).

Slot-batched: with UCI the PUSCH builds its own core: the demultiplex
positions come from the multiplex walk over index tags, once per
configuration, and the core gathers the UCI streams and the UL-SCH from
the descrambled LLRs and decodes each UCI stream
(rx/batch_core.py:make_uci_decoder).
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import on_device
from python_5gtoolbox_tpu_torch.ops.ldpc import sch_plan
from python_5gtoolbox_tpu_torch.ops.polar.segment import polar_cb_segment
from python_5gtoolbox_tpu_torch.phy import tbsize as tbs_mod
from python_5gtoolbox_tpu_torch.phy.pdsch_rx import (PdschRxMixin,
                                                     _batch_rx_fn,
                                                     copy_rx_pdsch_resource,
                                                     dmrs_ls_est,
                                                     rx_core_kwargs,
                                                     sch_decode)
from python_5gtoolbox_tpu_torch.phy.pusch import (NrPUSCH, _dmrs_seq_no_tp,
                                                  _dmrs_seq_tp,
                                                  pusch_dmrs_symlist, uci_on)
from python_5gtoolbox_tpu_torch.phy.pusch_uci import (get_ulsch_rm_info,
                                                      multiplex_tags,
                                                      stream_sizes)
from python_5gtoolbox_tpu_torch.rx.batch_core import (build_batch_rx_core,
                                                      data_re_layout,
                                                      make_uci_decoder)
from python_5gtoolbox_tpu_torch.rx.equalize import LINEAR_EQUALIZERS


def copy_rx_pusch_resource(rx_fd_slot, pusch_config: dict):
    """(Nr, 14*n_sc) slot tensor -> (pusch_resource (nsym, RB*12, Nr) on
    its device (numpy goes to the card), pusch_RE_usage (nsym, RB*12)
    int8 host map, 1 on DMRS and DMRS-reserved REs). The PUSCH's DMRS
    symbols follow the PDSCH's table, so this is copy_rx_pdsch_resource."""
    return copy_rx_pdsch_resource(rx_fd_slot, pusch_config)


def pusch_dmrs_ls_est(fd_slot_data, pusch_config: dict, slot: int):
    """LS channel estimate on the PUSCH DMRS REs of a (Nr, 14*n_sc) slot
    tensor -> (H_LS (sym, RB*3, Nr, NL), RS_info); the PRBS DMRS, or the
    low-PAPR one with transform precoding; on the slot's device (numpy
    goes to the card)."""
    cfg = pusch_config
    fd = on_device(fd_slot_data).to(torch.complex64)
    ra, dmrs = cfg["ResAlloType1"], cfg["DMRS"]
    symlist = pusch_dmrs_symlist(cfg["StartSymbolIndex"]
                                 + cfg["NrOfSymbols"], dmrs["DMRSAddPos"])
    if cfg["nTransPrecode"] == 0:
        n_scid = dmrs["nSCID"]
        tpd = dmrs["transformPrecodingDisabled"]
        nid = int(tpd["NID0"] if n_scid == 0 else tpd["NID1"])
        seqs = [_dmrs_seq_no_tp(n_scid, nid, ra["RBStart"] * 6,
                                ra["RBSize"] * 6, slot, sym)
                for sym in symlist]
    else:
        tpe = dmrs["transformPrecodingEnabled"]
        seqs = [_dmrs_seq_tp(tpe["nPuschID"], tpe["groupOrSequenceHopping"],
                             ra["RBSize"] * 6, slot, sym) for sym in symlist]
    seqs = torch.as_tensor(np.stack(seqs).astype(np.complex64),
                           device=fd.device)
    return dmrs_ls_est(fd, cfg, seqs, symlist, "nr_pusch")


def ulsch_decode(llr, tbsize: int, qm: int, rate1024: float, n_layers: int,
                 rv: int, ldpc_cfg: dict, harq_on: bool = False,
                 current_llr_dns=None):
    """UL-SCH decode chain -> (ok, tbblk, new_llr_dns (C, N)); Ncb = N
    (no LBRM on the UL). See phy/pdsch_rx.py:sch_decode."""
    return sch_decode(on_device(llr).to(torch.float32), tbsize, qm,
                      rate1024, n_layers, rv, None, ldpc_cfg, harq_on,
                      current_llr_dns)


def _ulsch_demux_maps(cfg: dict, g_total: int) -> dict:
    """The demultiplex positions of a slot's g_total LLRs."""
    symlist = pusch_dmrs_symlist(cfg["StartSymbolIndex"]
                                 + cfg["NrOfSymbols"],
                                 cfg["DMRS"]["DMRSAddPos"])
    tbsize, qm, rate1024 = tbs_mod.ulsch_tbsize(cfg)
    ulsch_size = 0
    if cfg["EnableULSCH"] == 1:
        info = sch_plan(tbsize, rate1024, g_total, qm,
                        cfg["num_of_layers"], None)[3]
        ulsch_size = info.C * info.K
    rm = get_ulsch_rm_info(cfg, symlist, ulsch_size, qm, rate1024, g_total)
    return data_control_demux_maps(cfg, symlist, rm, qm, g_total)


def ulsch_uci_decode_process(llr, pusch_config: dict, rv: int,
                             ldpc_cfg: dict, harq_on: bool = False,
                             current_llr_dns=None, decode_uci: bool = True,
                             maps: dict | None = None):
    """UL-SCH and UCI decode of one slot's (G,) descrambled LLRs (the
    reference's ULSCHandUCIDecodeProcess, with the UCI streams decoded)
    -> (ulsch ok, tbblk, new_llr_dns, uci {name: (bits, ok)}). maps: the
    demultiplex positions (default: from the configuration). On llr's
    device (numpy goes to the card)."""
    cfg = pusch_config
    llr = on_device(llr).to(torch.float32)
    if maps is None:
        maps = _ulsch_demux_maps(cfg, llr.shape[-1])
    part = {k: llr[torch.as_tensor(v, device=llr.device)]
            for k, v in maps.items()}
    uci = {}
    if decode_uci:
        for name, nb in (("ack", "NumACKBits"), ("csi1", "NumCSI1Bits"),
                         ("csi2", "NumCSI2Bits")):
            if part[name].numel():
                uci[name] = decode_uci_on_ulsch(part[name], cfg[nb],
                                                tbs_mod.ulsch_tbsize(cfg)[1])
    if cfg["EnableULSCH"] == 1:
        tbsize, qm, rate1024 = tbs_mod.ulsch_tbsize(cfg)
        ok, tbblk, new_llr = ulsch_decode(
            part["ulsch"], tbsize, qm, rate1024, cfg["num_of_layers"], rv,
            ldpc_cfg, harq_on, current_llr_dns)
        return ok, tbblk, new_llr, uci
    return False, np.array([]), np.array([]), uci


def data_control_demux_maps(pusch_config: dict, dmrs_symlist, rm_info: dict,
                            qm: int, g_total: int) -> dict:
    """The 6.2.7 placement walk over index tags (multiplex_tags) -> dict
    stream (ulsch, ack, csi1, csi2) -> int64 positions into the
    serialized LLR sequence. The UL-SCH positions come from a walk
    without the <= 2-bit ACK overwrite, so the positions the ACK punctures
    are still read (as the reference's separate reads them, corrupted,
    into g_ulsch)."""
    n = stream_sizes(pusch_config, rm_info)
    base, lo = {}, 1
    for name, size in n.items():
        base[name] = lo
        lo += size
    seq_no_ovw = multiplex_tags(pusch_config, g_total, dmrs_symlist,
                                rm_info, qm, ack_overwrite=False)
    small_ack = pusch_config["EnableACK"] * pusch_config["NumACKBits"] \
        in (1, 2)
    seq_ovw = multiplex_tags(pusch_config, g_total, dmrs_symlist, rm_info,
                             qm) if (n["ack"] and small_ack) else seq_no_ovw

    def positions(seq, name):
        mask = (seq >= base[name]) & (seq < base[name] + n[name])
        pos = np.nonzero(mask)[0]
        out = pos[np.argsort(seq[pos], kind="stable")]
        assert out.size == n[name]
        return out.astype(np.int64)

    return dict(ulsch=positions(seq_no_ovw, "ulsch"),
                ack=positions(seq_ovw, "ack"),
                csi1=positions(seq_no_ovw, "csi1"),
                csi2=positions(seq_no_ovw, "csi2"))


def data_control_separate(llr: torch.Tensor, pusch_config: dict,
                          dmrs_symlist, rm_info: dict, qm: int):
    """Inverse of data_control_multiplex: (..., G) LLRs -> (g_ulsch,
    g_ack, g_csi1, g_csi2) by gathers."""
    maps = data_control_demux_maps(pusch_config, dmrs_symlist, rm_info, qm,
                                   llr.shape[-1])
    return tuple(llr[..., torch.as_tensor(maps[k], device=llr.device)]
                 for k in ("ulsch", "ack", "csi1", "csi2"))


def decode_uci_on_ulsch(llr, n_bits: int, qm: int):
    """Decode one UCI stream (the inverse of encode_uci_on_ulsch): (E,)
    LLRs, a tensor (numpy goes to the card) -> (bits (n_bits,) int8
    tensor on llr's device, ok: the CRC pass of every polar block, True
    for the small-block codes). As the JAX package's per-slot decode, the
    polar rate recovery takes the block's length Er as its shortening LLR
    (the batched core uses 20)."""
    llr = on_device(llr).to(torch.float32)
    er = llr.shape[-1]
    if n_bits > 11:
        er = polar_cb_segment(np.zeros(n_bits, np.int8), er)[2]
    bits, ok = make_uci_decoder(n_bits, llr.shape[-1], qm,
                                llr_limit=er)(llr[None])
    return bits[0], bool(ok[0])


class PuschRxMixin:
    """RX methods mixed into NrPUSCH (phy/pusch.py)."""

    _RS_TYPE = "nr_pusch"

    def rx_process_batch(self, rx_fd_slots, slot_list, CEQ_config,
                         LDPC_decoder_config, ce_config, fetch=True,
                         rv=None, llr_prev=None, return_llr=False):
        """Slot-batched UL RX (see PdschRxMixin.rx_process_batch):
        (S, Nr, 14*nsc) + per-slot slot numbers -> (ok (S,) bool, tbblk
        (S, A) int8[, llr_dns]). Transform precoding needs 1 layer,
        NumCDM 2 and a linear equalizer; the IDFT de-precode runs inside
        the batched core. With UCI on PUSCH (CP-OFDM only, no HARQ
        chaining) -> (ok, tbblk, uci) with uci[name] = (bits (S, n)
        int8, ok (S,) bool) for name in ack, csi1, csi2."""
        cfg = self.cfg
        tp = cfg["nTransPrecode"] == 1
        if tp:
            assert cfg["num_of_layers"] == 1 \
                and cfg["DMRS"]["NumCDMGroupsWithoutData"] == 2 \
                and CEQ_config["algo"] in LINEAR_EQUALIZERS, \
                "batched TP RX needs 1 layer, NumCDM=2, linear equalizer"
        uci = uci_on(cfg)
        if uci:
            assert not tp, "batched UCI RX is CP-OFDM only"
            assert not (return_llr or llr_prev is not None), \
                "batched UCI RX has no HARQ chaining yet"
        assert cfg["EnableULSCH"] == 1
        out = PdschRxMixin.rx_process_batch(
            self, rx_fd_slots, slot_list, CEQ_config, LDPC_decoder_config,
            ce_config, fetch=fetch, rv=rv, llr_prev=llr_prev,
            return_llr=return_llr)
        if uci and fetch:
            ok, tbblk, dec = out
            return ok, tbblk, {name: (bits.cpu().numpy(), okk.cpu().numpy())
                               for name, (bits, okk) in dec.items()}
        return out

    rx_batch_prepare = PdschRxMixin.rx_batch_prepare

    def _rx_core(self, key: tuple):
        """The shared core without UCI; with UCI one built with this
        configuration's demultiplex positions, cached on the object."""
        if not uci_on(self.cfg):
            return _batch_rx_fn(key)
        ck = ("uci_core", key)
        if ck not in self._cache:
            kw = rx_core_kwargs(key)
            kw["uci_plan"] = self.uci_plan(kw["symlist"])
            fn, G = build_batch_rx_core(**kw)
            self._cache[ck] = (fn, G, kw["symlist"])
        return self._cache[ck]

    def uci_plan(self, symlist) -> dict:
        """dict(ulsch_pos=, streams=[(name, positions, n_bits)]): where the
        UL-SCH and each UCI stream lie in a slot's serialized LLRs."""
        cfg = self.cfg
        _, g_total = data_re_layout(
            tuple(cfg["PortIndexList"]), cfg["num_of_layers"],
            cfg["DMRS"]["NumCDMGroupsWithoutData"],
            cfg["ResAlloType1"]["RBSize"], cfg["StartSymbolIndex"],
            cfg["NrOfSymbols"], symlist, self.qm)
        maps = data_control_demux_maps(
            cfg, symlist, self.uci_rm_info(g_total, symlist), self.qm,
            g_total)
        streams = [(name, maps[name], int(cfg[nb]))
                   for name, nb in (("ack", "NumACKBits"),
                                    ("csi1", "NumCSI1Bits"),
                                    ("csi2", "NumCSI2Bits"))
                   if maps[name].size]
        return dict(ulsch_pos=maps["ulsch"], streams=streams)

    def RX_process(self, rx_fd_slot, slot, CEQ_config, H_result, cov_m,
                   LDPC_decoder_config, nrChannelEstimation=None,
                   HARQ_on=False, current_LLr_dns=None, decode_uci=True):
        """One received slot -> (ok, tbblk, llr_dns, uci {name: (bits,
        ok)}) on self.device; (False, empty, empty, {}) for a slot the
        configuration does not allocate. DFT-s-OFDM: de-precode, then the
        LLRs again (phy/pdsch_rx.py:PdschRxMixin._slot_llr). The rv is
        the next of the configuration's cycle."""
        if not self.is_active_slot(slot):
            return False, np.array([]), np.array([]), {}
        llr = self._slot_llr(rx_fd_slot, CEQ_config, H_result, cov_m,
                             nrChannelEstimation)
        key = ("demux_maps", llr.shape[-1])
        if key not in self._cache:
            self._cache[key] = _ulsch_demux_maps(self.cfg, llr.shape[-1])
        rv = self.getnextrv()
        return ulsch_uci_decode_process(
            llr, self.cfg, rv, LDPC_decoder_config, HARQ_on,
            current_LLr_dns, decode_uci=decode_uci,
            maps=self._cache[key])


def _attach_rx_methods():
    """Attach the receive path to NrPUSCH (phy/pusch.py)."""
    for name in ("rx_process_batch", "rx_batch_prepare", "_rx_core",
                 "uci_plan", "RX_process", "_RS_TYPE"):
        setattr(NrPUSCH, name, getattr(PuschRxMixin, name))
    for name in ("H_LS_est", "_slot_rx_plan", "_slot_llr"):
        setattr(NrPUSCH, name, getattr(PdschRxMixin, name))


_attach_rx_methods()
