"""PDSCH link-level throughput sweep (TX -> fading channel -> RX).

Port of scripts/internal/sim_pdsch_throughput_internal.py
(pdsch_before_ceq_processing, run_pdsch_throughput): per SNR point, the
slot-batched TX waveform, the channel filter, the fading channel with
AWGN, the RX filter and low-PHY, then per equalizer either one
slot-batched RX call (use_batch=True) or the reference-shaped per-slot
loop (H_LS_est -> rx/channel_estimate.py:NrChannelEstimation ->
RX_process, the rv cycle restarted per equalizer), which HARQ studies
need. Everything stays on the device; the decode flags of all points
come back in one transfer at the end. With
carrier_config["samplerate_in_mhz"] set (245.76 for the fixed output
rate) the waveform goes through the fused DUC, the channel runs at that
rate and the RX through the DDC. Also the OFDM + DUC run of the
repository's waveform bench (bench.py:bench_ofdm_duc).
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.models import channel as chan_mod
from python_5gtoolbox_tpu_torch.ops import filters
from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
from python_5gtoolbox_tpu_torch.rx.channel_estimate import (
    NrChannelEstimation, fo_est_valid_for_doppler)
from python_5gtoolbox_tpu_torch.utils.numerology import (carrier_prb_size,
                                                         fft_size,
                                                         slots_per_frame)
from python_5gtoolbox_tpu_torch.utils.profiling import span
from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf
from python_5gtoolbox_tpu_torch.waveform import rx as rx_wf

DEFAULT_CE_CONFIG = dict(enable_TO_comp=True, enable_FO_est=True,
                         enable_FO_comp=True, CE_algo="DFT",
                         L_symm_left_in_ns=200, L_symm_right_in_ns=200,
                         eRB=2)
DEFAULT_LDPC_CONFIG = dict(L=16, algo="min-sum", alpha=1.0, beta=0.0)

def slot_estimates(obj, slots, rx_fd, alloc, ce_config, prof=None):
    """The per-slot channel estimation of the reference's loop: for each
    allocated slot index in alloc, H_LS_est and NrChannelEstimation on
    the device -> [(rx_slot (Nr, 14*n_sc), slot, H, cov, est)], each
    charged to prof's channel_est stage (None: a span of the active
    profiler, if any)."""
    stage = span if prof is None else prof.stage
    slot_size = rx_fd.shape[1] // len(slots)
    out = []
    for i in alloc:
        rx_slot = rx_fd[:, i * slot_size: (i + 1) * slot_size]
        with stage("channel_est"):
            h_ls, rs_info = obj.H_LS_est(rx_slot, slots[i])
            est = NrChannelEstimation(h_ls, rs_info, dict(ce_config))
            H, cov = est.channel_est()
        out.append((rx_slot, slots[i], H, cov, est))
    return out


def rx_slots(obj, estimates, algo, ldpc_config, prof=None, **rx_kw):
    """RX_process of every (rx_slot, slot, H, cov, est) in order, the rv
    cycle restarted (rvidx -1) -> the list of RX_process results, each
    charged to prof's rx_process[<algo>] stage (None: a span of the
    active profiler, if any)."""
    stage = span if prof is None else prof.stage
    obj.rvidx = -1
    out = []
    for rx_slot, slot, H, cov, est in estimates:
        with stage(f"rx_process[{algo}]"):
            out.append(obj.RX_process(rx_slot, slot, {"algo": algo}, H, cov,
                                      ldpc_config, est, **rx_kw))
    return out


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
    (tx_waveform, channel, rx_lowphy); None records nothing, or spans of
    the active profiler where one is open.
    """
    dev = resolve_device(device)
    state = state or {}
    stage = span if prof is None else prof.stage
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
    with stage("tx_waveform"):
        _, _, dl, _ = dl_wf.gen_dl_waveform(
            waveform_config, carrier_config, nrPdsch_list=[nr_pdsch], Dm=dm,
            trblks=state.get("trblks"))
    with stage("channel"):
        rx = model.filter(dl, taps=state.get("taps"),
                          noise=state.get("noise"))
    with stage("rx_lowphy"):
        _, rx_fd = rx_wf.waveform_rx_processing(rx, carrier_config, fs_hz)
    spf = slots_per_frame(scs)
    slots = [(waveform_config["startslot"] + i) % spf for i in range(n_slots)]
    return nr_pdsch, slots, rx_fd


def run_pdsch_throughput(carrier_config, pdsch_config, chan_cfg,
                         snr_db_list, ceq_algo_list, n_slots=2,
                         ce_config=None, ldpc_config=None, seed=0,
                         prof=None, use_batch=True, device=None,
                         states=None):
    """-> dict algo -> [TB pass-rate per SNR] (+ 'tbs_bits').

    use_batch=True runs the whole RX, CE included, as one slot-batched
    call per (SNR, equalizer); False runs the reference-shaped per-slot
    loop (slot_estimates, then rx_slots per equalizer), the path HARQ
    studies need. Each SNR point i draws a fresh channel trajectory from
    seed + 7919 * i (as the JAX sweep does); states, one dict per SNR
    point, replaces the draws. device None -> cuda. prof as in
    pdsch_before_ceq_processing, plus rx_batch[<algo>] or channel_est
    and rx_process[<algo>] stages.
    """
    return run_sweep("PDSCH", pdsch_before_ceq_processing, carrier_config,
                     pdsch_config, chan_cfg, snr_db_list, ceq_algo_list,
                     n_slots, ce_config, ldpc_config, seed, device, states,
                     prof, use_batch=use_batch)


def run_sweep(label, before_ceq, carrier_config, ch_config, chan_cfg,
              snr_db_list, ceq_algo_list, n_slots, ce_config, ldpc_config,
              seed, device, states, prof, use_batch=True, rx_kw=None,
              uci=False):
    """The SNR loop of the PDSCH and PUSCH sweeps: before_ceq (the
    sweep's *_before_ceq_processing) makes each point's channel object,
    slot numbers and rx_fd (Nr, S*14*n_sc) from seed + 7919 * i, then per
    equalizer one slot-batched RX call on the allocated slots
    (use_batch) or the per-slot loop (RX_process with rx_kw) leaves the
    flags on the device; the flags of all points come back in one
    transfer at the end and print as '<label> snr=...' lines.

    uci (the PUSCH's UCI streams decoded): a slot passes a stream where
    its flag is set and its decoded bits are the bits sent
    (obj.uci_payload); those flags join the transfer, the results gain
    'uci': algo -> stream -> [pass rate per SNR] and each line a count
    per stream."""
    dev = resolve_device(device)
    stage = span if prof is None else prof.stage
    ldpc_config = dict(DEFAULT_LDPC_CONFIG, **(ldpc_config or {}))
    ce_cfg = _ce_config(ce_config, chan_cfg, carrier_config["scs"])
    period = ch_config["period_in_slot"]
    allocated = ch_config["allocated_slots"]
    pending = []      # (snr, n_alloc, {algo: [flags on the device]})
    streams = []      # the UCI streams, in the order of their flags
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
        sent = obj.uci_payload(len(alloc)) if uci else {}
        streams = list(sent)
        flags = {}
        if not use_batch:
            ests = slot_estimates(obj, slots, rx_fd, alloc, ce_cfg, prof)
            for algo in ceq_algo_list:
                outs = rx_slots(obj, ests, algo, ldpc_config, prof,
                                **(rx_kw or {}))
                flags[algo] = [torch.stack([o[0] for o in outs])]
                for name in streams:
                    bits = torch.stack([o[3][name][0] for o in outs])
                    ok = torch.tensor([bool(o[3][name][1]) for o in outs],
                                      device=bits.device)
                    flags[algo].append(_stream_passed(bits, ok, sent[name]))
            pending.append((snr, len(alloc), flags))
            continue
        nr_ant = rx_fd.shape[0]
        slot_size = rx_fd.shape[1] // n_slots
        full = rx_fd.reshape(nr_ant, n_slots, slot_size).transpose(0, 1)
        rx_stack = full if len(alloc) == n_slots else \
            full[torch.as_tensor(alloc, device=dev)]
        obj.rvidx = -1
        for algo in ceq_algo_list:
            with stage(f"rx_batch[{algo}]"):
                out = obj.rx_process_batch(
                    rx_stack, [slots[i] for i in alloc], {"algo": algo},
                    ldpc_config, ce_cfg, fetch=False)
            flags[algo] = [out[0]] + [
                _stream_passed(*out[2][name], sent[name]) for name in streams]
        pending.append((snr, len(alloc), flags))

    chunks = [f for _, _, flags in pending if flags
              for a in ceq_algo_list for f in flags[a]]
    flat = torch.cat(chunks).cpu().numpy() if chunks else None
    results = {algo: [] for algo in ceq_algo_list}
    if uci:
        results["uci"] = {algo: {name: [] for name in streams}
                          for algo in ceq_algo_list}
    off = 0
    for snr, ntot, flags in pending:
        for algo in ceq_algo_list:
            counts = []
            for _ in range(1 + len(streams)):
                n = 0
                if flags is not None:
                    n = int(np.sum(flat[off: off + ntot]))
                    off += ntot
                counts.append(n)
            results[algo].append(counts[0] / max(ntot, 1))
            line = f"{label} snr={snr:+.1f}dB {algo}: {counts[0]}/{ntot} " \
                   f"TB passed"
            for name, n in zip(streams, counts[1:]):
                results["uci"][algo][name].append(n / max(ntot, 1))
                line += f", {name} {n}/{ntot}"
            print(line)
    results["tbs_bits"] = obj.tbsize
    return results


def _stream_passed(bits, ok, sent) -> torch.Tensor:
    """(Sa,) bool on the device: a slot's UCI stream passed (its flag set
    and its decoded bits the bits sent)."""
    return ok.to(torch.bool) & (bits == sent.to(bits.device)).all(dim=1)


def harq_chains(carrier, pdsch_config, ce, ldpc, rv_cycle, pnoise_db,
                n_slots, algo="MMSE-IRC", device=None, seed=101):
    """A HARQ retransmission study over AWGN: transmission t sends every
    slot with rv_cycle[t] (noise seeded seed + t); the slot-batched chain
    (rx_process_batch with rv=, llr_prev=) and the per-slot chain
    (RX_process with HARQ_on, one receiver per slot) each combine the
    transmissions -> (ok_batched (T, S), ok_per_slot (T, S)) numpy
    bool."""
    dev = resolve_device(device)
    scs = carrier["scs"]
    prb = carrier_prb_size(scs, carrier["BW"])
    fs = fft_size(prb) * scs * 1000.0
    wf = dict(numofslots=n_slots, startSFN=0, startslot=0,
              samplerate_in_mhz=fs / 1e6)
    chan = chan_mod.gen_channel_model_config(
        model_format="AWGN", Nt=carrier["num_of_ant"], Nr=carrier["Nr"])
    stacks = []
    for t, rv in enumerate(rv_cycle):
        tx = Pdsch(dict(pdsch_config, rv=[rv]), carrier, device=dev)
        _, _, dl, _ = dl_wf.gen_dl_waveform(wf, carrier, nrPdsch_list=[tx])
        model = chan_mod.NrChannelModel(
            chan, pnoise_db, carrier["carrier_frequency_in_mhz"] * 1e6, fs,
            scs, seed=seed + t, device=dev)
        _, rx_fd = rx_wf.waveform_rx_processing(model.filter(dl), carrier,
                                                fs)
        stacks.append(rx_fd.reshape(carrier["Nr"], n_slots, -1)
                      .transpose(0, 1))
    rx_b = Pdsch(dict(pdsch_config, rv=list(rv_cycle)), carrier, device=dev)
    ok_b, llr = [], None
    for t, rv in enumerate(rv_cycle):
        ok, _, llr = rx_b.rx_process_batch(
            stacks[t], list(range(n_slots)), {"algo": algo}, ldpc, ce,
            fetch=False, rv=rv, llr_prev=llr, return_llr=True)
        ok_b.append(ok)
    ok_s = []
    for i in range(n_slots):
        rx_i = Pdsch(dict(pdsch_config, rv=list(rv_cycle)), carrier,
                     device=dev)
        prev, oks = None, []
        for t in range(len(rv_cycle)):
            h_ls, info = rx_i.H_LS_est(stacks[t][i], i)
            est = NrChannelEstimation(h_ls, info, dict(ce))
            H, cov = est.channel_est()
            ok, _, prev = rx_i.RX_process(stacks[t][i], i, {"algo": algo},
                                          H, cov, ldpc, est, HARQ_on=True,
                                          current_LLr_dns=prev)
            oks.append(ok)
        ok_s.append(torch.stack(oks))
    return (torch.stack(ok_b).cpu().numpy(),
            torch.stack(ok_s, dim=1).cpu().numpy())
