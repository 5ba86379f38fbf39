"""PDSCH slot-batched receive path, shared with the PUSCH.

Port of the batched RX of python_5gtoolbox_tpu/phy/pdsch_rx.py
(_batch_rx_fn, rx_batch_prepare, rx_process_batch): one call runs LS
estimation, DFT CE, TO/FO compensation, equalization, demod,
descrambling, rate recovery, LDPC decode and the TB CRC for a stack of
slots (rx/batch_core.py). The UL-SCH takes the same path
(phy/pusch_rx.py) with Ncb = N (tbs_lbrm None) and, for DFT-s-OFDM, the
de-precode branch of the core; the channel object gives the DMRS
sequence (dmrs_seq), the scrambling c_init (scramble_cinit) and the core
(_rx_core: the PUSCH builds its own with UCI). The per-slot RX_process
is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.pdsch import get_dmrs_symlist


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
        """
        harq = return_llr or llr_prev is not None
        dev = self.device
        rx = torch.as_tensor(rx_fd_slots, device=dev).to(torch.complex64)
        cache = self._cache
        ck = ("rx", tuple(int(s) for s in slot_list), CEQ_config["algo"],
              harq, None if rv is None else int(rv), rx.shape[1],
              tuple(sorted((k, v) for k, v in LDPC_decoder_config.items()
                           if not callable(v))),
              tuple(sorted((k, v) for k, v in ce_config.items()
                           if isinstance(v, (int, float, str, bool)))))
        if ck not in cache:
            fn, dmrs, scr_sign = self.rx_batch_prepare(
                rx.shape[1], slot_list, CEQ_config, LDPC_decoder_config,
                ce_config, rv=rv, harq=harq)
            cache[ck] = (fn, torch.as_tensor(dmrs, device=dev),
                         torch.as_tensor(scr_sign, device=dev))
        fn, dmrs, scr_sign = cache[ck]
        if harq:
            prev = None if llr_prev is None else torch.as_tensor(
                llr_prev, device=dev)
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
