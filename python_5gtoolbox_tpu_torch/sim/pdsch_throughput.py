"""PDSCH link-level throughput sweep (TX -> fading channel -> batched RX).

Port of scripts/internal/sim_pdsch_throughput_internal.py
(pdsch_before_ceq_processing with do_ce=False, run_pdsch_throughput with
use_batch=True): per SNR point, the slot-batched TX waveform, the channel
filter, the fading channel with AWGN, the RX filter and low-PHY, then one
slot-batched RX call per equalizer. Everything stays on the device; the
decode flags of all points come back in one transfer at the end. With
carrier_config["samplerate_in_mhz"] set (245.76 for the fixed output
rate) the waveform goes through the fused DUC, the channel runs at that
rate and the RX through the DDC. Also the OFDM + DUC run of the
repository's waveform bench (bench.py:bench_ofdm_duc).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.models import channel as chan_mod
from python_5gtoolbox_tpu_torch.ops import filters
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
from python_5gtoolbox_tpu_torch.utils.numerology import (carrier_prb_size,
                                                         fft_size,
                                                         slots_per_frame)
from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf
from python_5gtoolbox_tpu_torch.waveform import rx as rx_wf

DEFAULT_CE_CONFIG = dict(enable_TO_comp=True, enable_FO_est=True,
                         enable_FO_comp=True, CE_algo="DFT",
                         L_symm_left_in_ns=200, L_symm_right_in_ns=200,
                         eRB=2)
DEFAULT_LDPC_CONFIG = dict(L=16, algo="min-sum", alpha=1.0, beta=0.0)

# rx/channel_estimate.py of the JAX package: above this fraction of the
# subcarrier spacing the FO estimator reads fading rotation as CFO
FO_EST_FM_LIMIT_FRACTION = 0.002


def fo_est_valid_for_doppler(fm_hz: float, scs: int) -> bool:
    """True if freq_offset_est's error floor is acceptable at this f_m."""
    return fm_hz <= FO_EST_FM_LIMIT_FRACTION * scs * 1000.0


class _NullProfiler:
    @contextlib.contextmanager
    def stage(self, name):
        yield


def bench_link_level_config():
    """(carrier, pdsch, channel, ce, ldpc) configs of the repository's
    link-level bench (bench.py:bench_link_level): BW 20 MHz, scs 30, 2 TX
    x 4 RX, 2 layers on 20 RBs, MCS 2 of the 256QAM table, Rayleigh at
    fm 200 Hz, DFT CE, mixed min-sum L=16."""
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    carrier = merged(get_default_config("dl_carrier"),
                     dict(BW=20, scs=30, num_of_ant=2, Nr=4,
                          maxMIMO_layers=2, PCI=1,
                          carrier_frequency_in_mhz=3840.0))
    pdsch = merged(get_default_config("pdsch"),
                   dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                        rv=[0], data_source=[], StartSymbolIndex=2,
                        NrOfSymbols=12))
    pdsch["ResAlloType1"].update(RBStart=0, RBSize=20)
    pdsch["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                         DMRSAddPos=1)
    pdsch["precoding_matrix"] = np.empty(0)
    chan = chan_mod.gen_channel_model_config(
        model_format="customized", Nt=2, Nr=4, fm_inHz=200,
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    ce = dict(CE_algo="DFT", L_symm_left_in_ns=200,
              L_symm_right_in_ns=200, eRB=2, enable_TO_comp=True,
              enable_FO_est=False, enable_FO_comp=False)
    ldpc = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
    return carrier, pdsch, chan, ce, ldpc


def small_alloc_link_level_config():
    """The bench configuration on a small allocation: mcs_index 0 on 12
    RBs (2 layers kept), the small-packet end of the same sweep. TBS 736,
    base graph 2, one code block at Zc 80, so the decode goes through the
    small-lifting kernel. 12 RBs stay above the 8 RBs under which the
    bench CE window keeps no channel tap."""
    carrier, pdsch, chan, ce, ldpc = bench_link_level_config()
    pdsch["mcs_index"] = 0
    pdsch["ResAlloType1"]["RBSize"] = 12
    return carrier, pdsch, chan, ce, ldpc


def bench_ofdm_duc_config() -> dict:
    """Shape of the repository's OFDM + DUC bench (bench.py:bench_ofdm_duc):
    scs 30, BW 100 MHz (nfft 4096, 287-tap FIR), 64 slots, 2 antennas,
    carrier 3500 MHz, output at 245.76 Msps (oversample 2)."""
    return dict(scs=30, bw=100, n_slots=64, nant=2,
                carrier_freq_hz=int(3500e6), out_rate_hz=245.76e6)


def ofdm_duc_grid(cfg: dict, seed: int = 0, device=None) -> torch.Tensor:
    """Random complex64 (ant, slots, 14, n_sc) frequency grid for
    run_ofdm_duc, unit-variance normal parts drawn with numpy from seed."""
    dev = resolve_device(device)
    n_sc = 12 * carrier_prb_size(cfg["scs"], cfg["bw"])
    shape = (cfg["nant"], cfg["n_slots"], 14, n_sc)
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(shape, dtype=np.float32)
    im = rng.standard_normal(shape, dtype=np.float32)
    return torch.complex(torch.as_tensor(re, device=dev),
                         torch.as_tensor(im, device=dev))


def run_ofdm_duc(fd: torch.Tensor, cfg: dict | None = None, device=None):
    """OFDM modulation + DUC of an antenna-major (ant, slots, 14, n_sc)
    grid at the configuration cfg (default bench_ofdm_duc_config) ->
    (re, im) float32 waveform planes, each (ant, oversample * slots *
    slot_samples), on the device (None -> cuda)."""
    cfg = cfg or bench_ofdm_duc_config()
    dev = resolve_device(device)
    return filters.tx_lowphy_duc(fd.to(dev), cfg["scs"], cfg["bw"],
                                 cfg["carrier_freq_hz"], cfg["out_rate_hz"],
                                 as_planes="split")


def _ce_config(ce_config, chan_cfg, scs):
    ce = dict(DEFAULT_CE_CONFIG, **(ce_config or {}))
    fm = float(chan_cfg.get("fm_inHz", 0) or 0)
    if ce.get("enable_FO_est") and not fo_est_valid_for_doppler(fm, scs):
        ce["enable_FO_est"] = False
        ce["enable_FO_comp"] = False
    return ce


def pdsch_before_ceq_processing(carrier_config, pdsch_config, chan_cfg,
                                pnoise_db, n_slots=2, seed=0,
                                device=None, state=None, prof=None):
    """TX + channel + Rx low-PHY for n_slots slots.

    -> (nr_pdsch, slot numbers, rx_fd (Nr, S*14*n_sc) complex64 on the
    device). The transport blocks come from numpy's Generator seeded with
    `seed`, the channel from a torch.Generator seeded with `seed`; state
    (interop.state_from_numpy) replaces those draws. prof: optional
    object whose stage(name) context manager wraps each stage
    (tx_waveform, channel, rx_lowphy).
    """
    dev = resolve_device(device)
    state = state or {}
    prof = prof or _NullProfiler()
    scs, bw = carrier_config["scs"], carrier_config["BW"]
    nfft = fft_size(carrier_prb_size(scs, bw))
    fs_hz = carrier_config["samplerate_in_mhz"] * 1e6 \
        if "samplerate_in_mhz" in carrier_config else nfft * scs * 1000.0
    waveform_config = dict(numofslots=n_slots, startSFN=0, startslot=0,
                           samplerate_in_mhz=fs_hz / 1e6)
    nr_pdsch = Pdsch(pdsch_config, carrier_config,
                     rng=np.random.default_rng(seed), device=dev)
    model = chan_mod.NrChannelModel(
        chan_cfg, pnoise_db, carrier_config["carrier_frequency_in_mhz"] * 1e6,
        fs_hz, scs, seed=seed, device=dev)
    dm = model.gen_Dm(n_slots)
    with prof.stage("tx_waveform"):
        _, _, dl, _ = dl_wf.gen_dl_waveform(
            waveform_config, carrier_config, nrPdsch_list=[nr_pdsch], Dm=dm,
            trblks=state.get("trblks"))
    with prof.stage("channel"):
        rx = model.filter(dl, taps=state.get("taps"),
                          noise=state.get("noise"))
    with prof.stage("rx_lowphy"):
        _, rx_fd = rx_wf.waveform_rx_processing(rx, carrier_config, fs_hz)
    spf = slots_per_frame(scs)
    slots = [(waveform_config["startslot"] + i) % spf for i in range(n_slots)]
    return nr_pdsch, slots, rx_fd


def run_pdsch_throughput(carrier_config, pdsch_config, chan_cfg,
                         snr_db_list, ceq_algo_list, n_slots=2,
                         ce_config=None, ldpc_config=None, seed=0,
                         device=None, states=None, prof=None):
    """-> dict algo -> [TB pass-rate per SNR] (+ 'tbs_bits').

    Each SNR point i draws a fresh channel trajectory from seed +
    7919 * i (as the JAX sweep does); states, one dict per SNR point,
    replaces the draws. device None -> cuda. prof as in
    pdsch_before_ceq_processing, plus an rx_batch[<algo>] stage.
    """
    return run_sweep("PDSCH", pdsch_before_ceq_processing, carrier_config,
                     pdsch_config, chan_cfg, snr_db_list, ceq_algo_list,
                     n_slots, ce_config, ldpc_config, seed, device, states,
                     prof)


def run_sweep(label, before_ceq, carrier_config, ch_config, chan_cfg,
              snr_db_list, ceq_algo_list, n_slots, ce_config, ldpc_config,
              seed, device, states, prof):
    """The SNR loop of the PDSCH and PUSCH sweeps: before_ceq (the
    sweep's *_before_ceq_processing) makes each point's channel object,
    slot numbers and rx_fd (Nr, S*14*n_sc) from seed + 7919 * i, then one
    slot-batched RX call per equalizer on the allocated slots leaves the
    flags on the device; the flags of all points come back in one
    transfer at the end and print as '<label> snr=...' lines."""
    dev = resolve_device(device)
    prof_ = prof or _NullProfiler()
    ldpc_config = dict(DEFAULT_LDPC_CONFIG, **(ldpc_config or {}))
    ce_cfg = _ce_config(ce_config, chan_cfg, carrier_config["scs"])
    period = ch_config["period_in_slot"]
    allocated = ch_config["allocated_slots"]
    pending = []      # (snr, n_alloc, {algo: ok flags on the device})
    obj = None
    for i_snr, snr in enumerate(snr_db_list):
        obj, slots, rx_fd = before_ceq(
            carrier_config, ch_config, chan_cfg, -snr, n_slots,
            seed + 7919 * i_snr, device=dev,
            state=None if states is None else states[i_snr], prof=prof)
        alloc = [i for i, slot in enumerate(slots)
                 if (slot % period) in allocated]
        if not alloc:
            pending.append((snr, 0, None))
            continue
        nr_ant = rx_fd.shape[0]
        slot_size = rx_fd.shape[1] // n_slots
        full = rx_fd.reshape(nr_ant, n_slots, slot_size).transpose(0, 1)
        rx_stack = full if len(alloc) == n_slots else \
            full[torch.as_tensor(alloc, device=dev)]
        obj.rvidx = -1
        oks = {}
        for algo in ceq_algo_list:
            with prof_.stage(f"rx_batch[{algo}]"):
                oks[algo], _ = obj.rx_process_batch(
                    rx_stack, [slots[i] for i in alloc], {"algo": algo},
                    ldpc_config, ce_cfg, fetch=False)
        pending.append((snr, len(alloc), oks))

    chunks = [oks[a] for _, _, oks in pending if oks for a in ceq_algo_list]
    flat = torch.cat(chunks).cpu().numpy() if chunks else None
    results = {algo: [] for algo in ceq_algo_list}
    off = 0
    for snr, ntot, oks in pending:
        for algo in ceq_algo_list:
            npass = 0
            if oks is not None:
                npass = int(np.sum(flat[off: off + ntot]))
                off += ntot
            results[algo].append(npass / max(ntot, 1))
            print(f"{label} snr={snr:+.1f}dB {algo}: {npass}/{ntot} "
                  f"TB passed")
    results["tbs_bits"] = obj.tbsize
    return results
