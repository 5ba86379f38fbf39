"""PUSCH slot-batched receive path (UL-SCH, CP-OFDM and DFT-s-OFDM, UCI
on PUSCH) and the UCI demultiplex and decoders.

Port of the batched RX of python_5gtoolbox_tpu/phy/pusch_rx.py
(_batch_ul_rx_fn, _batch_ul_uci_fn, PuschRxMixin.rx_process_batch) and
of its data/control demultiplex and UCI decode (data_control_demux_maps,
data_control_separate, decode_uci_on_ulsch). The PDSCH's RX methods
(phy/pdsch_rx.py) serve both links, with NrPUSCH.tbs_lbrm None and the
DMRS from NrPUSCH.dmrs_seq (PRBS, or low-PAPR per slot and symbol). With
UCI the PUSCH builds its own core: the 38.212 6.2.7 demultiplex
positions come from the multiplex walk over index tags, once per
configuration, and the core gathers the UCI streams and the UL-SCH from
the descrambled LLRs and decodes each UCI stream
(rx/batch_core.py:make_uci_decoder). The per-slot RX_process (Queue A
item 4) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.polar.segment import polar_cb_segment
from python_5gtoolbox_tpu_torch.phy.pdsch_rx import (PdschRxMixin,
                                                     _batch_rx_fn,
                                                     rx_core_kwargs)
from python_5gtoolbox_tpu_torch.phy.pusch import uci_on
from python_5gtoolbox_tpu_torch.phy.pusch_uci import (multiplex_tags,
                                                      stream_sizes)
from python_5gtoolbox_tpu_torch.rx.batch_core import (build_batch_rx_core,
                                                      data_re_layout,
                                                      make_uci_decoder)
from python_5gtoolbox_tpu_torch.rx.equalize import LINEAR_EQUALIZERS


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
    LLRs, numpy or a tensor -> (bits (n_bits,) int8 tensor on llr's
    device, ok: the CRC pass of every polar block, True for the
    small-block codes). As the JAX package's per-slot decode, the polar
    rate recovery takes the block's length Er as its shortening LLR (the
    batched core uses 20)."""
    llr = torch.as_tensor(llr).to(torch.float32)
    er = llr.shape[-1]
    if n_bits > 11:
        er = polar_cb_segment(np.zeros(n_bits, np.int8), er)[2]
    bits, ok = make_uci_decoder(n_bits, llr.shape[-1], qm,
                                llr_limit=er)(llr[None])
    return bits[0], bool(ok[0])


class PuschRxMixin:
    """RX methods mixed into NrPUSCH (phy/pusch.py)."""

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

    def RX_process(self, *args, **kwargs):
        raise NotImplementedError("the per-slot PUSCH RX is not ported "
                                  "(Queue A item 4); use rx_process_batch")
