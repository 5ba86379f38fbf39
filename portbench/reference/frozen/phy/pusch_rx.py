"""PUSCH receive path, slot-batched UL-SCH without UCI (frozen copy).

A frozen copy of the port's phy/pusch_rx.py, cut to the slot-batched
UL-SCH RX without UCI: the PDSCH's batched core (phy/pdsch_rx.py,
rx/batch_core.py) with Ncb = N and the PUSCH's DMRS and scrambling.
"""
from __future__ import annotations

from portbench.reference.frozen.phy.pdsch_rx import (PdschRxMixin,
                                                     _batch_rx_fn)
from portbench.reference.frozen.phy.pusch import NrPUSCH, uci_on
from portbench.reference.frozen.rx.equalize import LINEAR_EQUALIZERS


class PuschRxMixin:
    """RX methods mixed into NrPUSCH (phy/pusch.py)."""

    _RS_TYPE = "nr_pusch"

    def rx_process_batch(self, rx_fd_slots, slot_list, CEQ_config,
                         LDPC_decoder_config, ce_config, fetch=True,
                         rv=None, llr_prev=None, return_llr=False):
        """Slot-batched UL RX (see PdschRxMixin.rx_process_batch)."""
        cfg = self.cfg
        if cfg["nTransPrecode"] == 1:
            assert cfg["num_of_layers"] == 1 \
                and cfg["DMRS"]["NumCDMGroupsWithoutData"] == 2 \
                and CEQ_config["algo"] in LINEAR_EQUALIZERS, \
                "batched TP RX needs 1 layer, NumCDM=2, linear equalizer"
        assert cfg["EnableULSCH"] == 1 and not uci_on(cfg)
        return PdschRxMixin.rx_process_batch(
            self, rx_fd_slots, slot_list, CEQ_config, LDPC_decoder_config,
            ce_config, fetch=fetch, rv=rv, llr_prev=llr_prev,
            return_llr=return_llr)

    rx_batch_prepare = PdschRxMixin.rx_batch_prepare

    def _rx_core(self, key: tuple):
        return _batch_rx_fn(key)


def _attach_rx_methods():
    """Attach the receive path to NrPUSCH (phy/pusch.py)."""
    for name in ("rx_process_batch", "rx_batch_prepare", "_rx_core",
                 "_RS_TYPE"):
        setattr(NrPUSCH, name, getattr(PuschRxMixin, name))


_attach_rx_methods()
