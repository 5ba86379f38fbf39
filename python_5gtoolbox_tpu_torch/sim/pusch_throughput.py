"""PUSCH link-level throughput sweep (TX -> fading channel -> RX).

Port of scripts/internal/sim_pusch_throughput_internal.py
(can_batch_pusch_rx, pusch_before_ceq_processing, run_pusch_throughput):
per SNR point, the UL waveform (slot-batched through
filters.tx_lowphy_duc, or per slot with UCI), the fading channel with
AWGN, the RX filter and low-PHY, then per equalizer one slot-batched RX
call (CP-OFDM or DFT-s-OFDM without UCI) or the per-slot loop
(H_LS_est -> NrChannelEstimation -> NrPUSCH.RX_process, decoding the
UCI streams with decode_uci), to which the JAX sweep sends every UCI
configuration. Everything stays on the device; the decode flags of all
points come back in one transfer at the end (the SNR loop is
pdsch_throughput.run_sweep).
"""
from __future__ import annotations

import numpy as np

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.models import channel as chan_mod
from python_5gtoolbox_tpu_torch.phy.pusch import (NrPUSCH, draw_uci_bits,
                                                  uci_drawn, uci_on)
from python_5gtoolbox_tpu_torch.rx.equalize import LINEAR_EQUALIZERS
from python_5gtoolbox_tpu_torch.sim.pdsch_throughput import run_sweep
from python_5gtoolbox_tpu_torch.utils.profiling import span
from python_5gtoolbox_tpu_torch.utils.numerology import (carrier_prb_size,
                                                         fft_size,
                                                         slots_per_frame)
from python_5gtoolbox_tpu_torch.waveform import rx as rx_wf
from python_5gtoolbox_tpu_torch.waveform import ul as ul_wf


def can_batch_pusch_rx(pusch_config: dict, algos=None) -> bool:
    """True when the slot-batched UL-SCH RX covers this config: UL-SCH
    only (no UCI), CP-OFDM, or DFT-s-OFDM with 1 layer, NumCDM 2 and
    linear equalizers only."""
    cfg = pusch_config
    if cfg["EnableULSCH"] != 1 or uci_on(cfg):
        return False
    if cfg["nTransPrecode"] == 1:
        if not (cfg["num_of_layers"] == 1
                and cfg["DMRS"]["NumCDMGroupsWithoutData"] == 2):
            return False
        if algos is not None and any(a not in LINEAR_EQUALIZERS
                                     for a in algos):
            return False
    return True


def bench_link_level_pusch_tp_config():
    """(carrier, pusch, channel, ce, ldpc) configs of the repository's
    transform-precoded UL sweep (bench.py:bench_link_level_pusch_tp): BW
    20 MHz, scs 30, 1 TX x 2 RX, 1 layer on 48 RBs, MCS 2 of
    MCStable61411, 14 symbols, DMRSAddPos 1, NumCDM 2, DFT-s-OFDM,
    Rayleigh at fm 200 Hz, DFT CE, mixed min-sum L=16."""
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    carrier = merged(get_default_config("ul_carrier"),
                     dict(BW=20, scs=30, num_of_ant=1, Nr=2,
                          maxMIMO_layers=1, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    pusch = merged(get_default_config("pusch"),
                   dict(mcs_table="MCStable61411", mcs_index=2,
                        nTpPi2BPSK=0, num_of_layers=1, rv=[0],
                        data_source=[], StartSymbolIndex=0,
                        NrOfSymbols=14, nTransPrecode=1, EnableULSCH=1,
                        EnableACK=0, EnableCSI1=0, EnableCSI2=0,
                        PortIndexList=[1000], nNrOfAntennaPorts=1,
                        nPMI=0))
    pusch["ResAlloType1"].update(RBStart=0, RBSize=48)   # 48 = 2^4 * 3
    pusch["DMRS"].update(NumCDMGroupsWithoutData=2, DMRSAddPos=1)
    chan = chan_mod.gen_channel_model_config(
        model_format="customized", Nt=1, Nr=2, fm_inHz=200,
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    ce = dict(CE_algo="DFT", L_symm_left_in_ns=200,
              L_symm_right_in_ns=200, eRB=2, enable_TO_comp=True,
              enable_FO_est=False, enable_FO_comp=False)
    ldpc = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
    return carrier, pusch, chan, ce, ldpc


def pusch_before_ceq_processing(carrier_config, pusch_config, chan_cfg,
                                pnoise_db, n_slots=2, seed=0, device=None,
                                state=None, prof=None):
    """TX + channel + Rx low-PHY for n_slots slots at the carrier rate.

    -> (nr_pusch, slot numbers, rx_fd (Nr, S*14*n_sc) complex64 on the
    device). The transport blocks come from numpy's Generator seeded with
    `seed`, the channel from a torch.Generator seeded with `seed`, the UCI
    payloads of streams with an empty payload list from draw_uci_bits
    (seed), kept as nr_pusch.uci_bits; state (interop.state_from_numpy,
    and uci_bits={name: (Sa, n bits) int8}) replaces those draws. prof:
    optional object whose stage(name) context manager wraps each stage
    (tx_waveform, channel, rx_lowphy); None records nothing, or spans of
    the active profiler where one is open.
    """
    dev = resolve_device(device)
    state = state or {}
    stage = span if prof is None else prof.stage
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    fs_hz = fft_size(carrier_prb_size(scs, bw)) * scs * 1000.0
    waveform_config = dict(numofslots=n_slots, startSFN=0, startslot=0,
                           samplerate_in_mhz=fs_hz / 1e6)
    nr_pusch = NrPUSCH(carrier_config, pusch_config,
                       rng=np.random.default_rng(seed), device=dev)
    model = chan_mod.NrChannelModel(
        chan_cfg, pnoise_db, carrier_config["carrier_frequency_in_mhz"] * 1e6,
        fs_hz, scs, seed=seed, device=dev)
    spf = slots_per_frame(scs)
    slots = [(waveform_config["startslot"] + i) % spf for i in range(n_slots)]
    nr_pusch.uci_bits = state.get("uci_bits")
    if nr_pusch.uci_bits is None and uci_drawn(pusch_config):
        nr_pusch.uci_bits = draw_uci_bits(
            pusch_config, sum(map(nr_pusch.is_active_slot, slots)), seed, dev)
    with stage("tx_waveform"):
        _, _, ul = ul_wf.gen_ul_waveform(
            waveform_config, carrier_config, nrPusch_list=[nr_pusch],
            return_device=True, trblks=state.get("trblks"))
    with stage("channel"):
        rx = model.filter(ul, taps=state.get("taps"),
                          noise=state.get("noise"))
    with stage("rx_lowphy"):
        _, rx_fd = rx_wf.waveform_rx_processing(rx, carrier_config, fs_hz)
    return nr_pusch, slots, rx_fd


def run_pusch_throughput(carrier_config, pusch_config, chan_cfg,
                         snr_db_list, ceq_algo_list, n_slots=2,
                         ce_config=None, ldpc_config=None, seed=0,
                         decode_uci=False, use_batch=None, prof=None,
                         device=None, states=None):
    """-> dict algo -> [TB pass-rate per SNR] (+ 'tbs_bits', and with UCI
    decoded, 'uci': algo -> stream -> [pass rate per SNR]).

    use_batch None picks the slot-batched RX where the config supports
    it (can_batch_pusch_rx) and no UCI decode is asked for, else the
    per-slot RX_process loop (decode_uci decodes the UCI streams there).
    Each SNR point i draws from seed + 7919 * i (as the JAX sweep does);
    states, one dict per SNR point, replaces the draws. device None ->
    cuda. prof as in pusch_before_ceq_processing, plus rx_batch[<algo>]
    or channel_est and rx_process[<algo>] stages.
    """
    if use_batch is None:
        use_batch = can_batch_pusch_rx(pusch_config, ceq_algo_list) \
            and not decode_uci
    return run_sweep("PUSCH", pusch_before_ceq_processing, carrier_config,
                     pusch_config, chan_cfg, snr_db_list, ceq_algo_list,
                     n_slots, ce_config, ldpc_config, seed, device, states,
                     prof, use_batch=use_batch,
                     rx_kw=dict(decode_uci=decode_uci),
                     uci=uci_on(pusch_config) and (use_batch or decode_uci))
