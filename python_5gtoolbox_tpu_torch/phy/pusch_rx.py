"""PUSCH slot-batched receive path (UL-SCH, CP-OFDM and DFT-s-OFDM).

Port of the batched RX of python_5gtoolbox_tpu/phy/pusch_rx.py
(_batch_ul_rx_fn, PuschRxMixin.rx_process_batch). The JAX package builds
the UL core apart only for its deltas (the PUSCH DMRS sequences, Ncb = N,
the de-precode branch); here the PDSCH's RX methods (phy/pdsch_rx.py)
serve both, with NrPUSCH.tbs_lbrm None and the DMRS from
NrPUSCH.dmrs_seq (PRBS, or low-PAPR per slot and symbol). This module
adds the limits of the batched UL path. UCI on PUSCH (Queue A item 2)
and the per-slot RX_process (Queue A item 4) are not ported.
"""
from __future__ import annotations

from python_5gtoolbox_tpu_torch.phy.pdsch_rx import PdschRxMixin
from python_5gtoolbox_tpu_torch.phy.pusch import uci_on
from python_5gtoolbox_tpu_torch.rx.equalize import LINEAR_EQUALIZERS


class PuschRxMixin:
    """RX methods mixed into NrPUSCH (phy/pusch.py)."""

    def rx_process_batch(self, rx_fd_slots, slot_list, CEQ_config,
                         LDPC_decoder_config, ce_config, fetch=True,
                         rv=None, llr_prev=None, return_llr=False):
        """Slot-batched UL-SCH RX (see PdschRxMixin.rx_process_batch):
        (S, Nr, 14*nsc) + per-slot slot numbers -> (ok (S,) bool, tbblk
        (S, A) int8[, llr_dns]). Transform precoding needs 1 layer,
        NumCDM 2 and a linear equalizer; the IDFT de-precode runs inside
        the batched core."""
        cfg = self.cfg
        if cfg["nTransPrecode"] == 1:
            assert cfg["num_of_layers"] == 1 \
                and cfg["DMRS"]["NumCDMGroupsWithoutData"] == 2 \
                and CEQ_config["algo"] in LINEAR_EQUALIZERS, \
                "batched TP RX needs 1 layer, NumCDM=2, linear equalizer"
        if uci_on(cfg):
            raise NotImplementedError("UCI on PUSCH is not ported (Queue A "
                                      "item 2)")
        assert cfg["EnableULSCH"] == 1
        return PdschRxMixin.rx_process_batch(
            self, rx_fd_slots, slot_list, CEQ_config, LDPC_decoder_config,
            ce_config, fetch=fetch, rv=rv, llr_prev=llr_prev,
            return_llr=return_llr)

    rx_batch_prepare = PdschRxMixin.rx_batch_prepare

    def RX_process(self, *args, **kwargs):
        raise NotImplementedError("the per-slot PUSCH RX is not ported "
                                  "(Queue A item 4); use rx_process_batch")
