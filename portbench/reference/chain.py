"""The plain reference of one SNR point of a link-level cell.

From the same inputs as the program (the configuration's dicts, the SNR,
the point's seed and the transport blocks the benchmark drew), the frozen
chain under reference/frozen works out again every stage the timed path
derived: the TX waveform, the fading channel with its taps and noise (the
same torch.Generator draws from the point's seed, on the same device),
the RX front end's grid, each equalizer's LLRs, and the decoded transport
blocks with their CRC flags, slot-batched or per slot as the cell runs
the receiver.

bf16=True is the precision control: every stage's output (TX waveform,
channel output, grid, LLRs) is rounded to bfloat16 before the next stage
reads it, i.e. the chain keeps its signals in bfloat16 and computes in
float32.

Imports nothing of the program: only the frozen copy, numpy and torch.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.frozen.models import channel as chan_mod
from portbench.reference.frozen.phy import pdsch_rx as pdsch_rx_mod
from portbench.reference.frozen.phy.pdsch import Pdsch
from portbench.reference.frozen.phy.pusch import NrPUSCH
from portbench.reference.frozen.rx import batch_core
from portbench.reference.frozen.rx.channel_estimate import (
    NrChannelEstimation, fo_est_valid_for_doppler)
from portbench.reference.frozen.utils.numerology import (carrier_prb_size,
                                                         fft_size,
                                                         slots_per_frame)
from portbench.reference.frozen.waveform import dl as dl_wf
from portbench.reference.frozen.waveform import rx as rx_wf
from portbench.reference.frozen.waveform import ul as ul_wf

# the port's sweep defaults (sim/pdsch_throughput.py), merged under the
# configuration's own CE and LDPC settings
DEFAULT_CE_CONFIG = dict(enable_TO_comp=True, enable_FO_est=True,
                         enable_FO_comp=True, CE_algo="DFT",
                         L_symm_left_in_ns=200, L_symm_right_in_ns=200,
                         eRB=2)
DEFAULT_LDPC_CONFIG = dict(L=16, algo="min-sum", alpha=1.0, beta=0.0)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back (real and imaginary parts apart)."""
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).to(torch.float32),
                             x.imag.to(torch.bfloat16).to(torch.float32))
    return x.to(torch.bfloat16).to(x.dtype)


def channel_config(channel: dict, carrier: dict) -> dict:
    """The channel model's dict from a traffic file's channel entry, for
    the carrier's Nt x Nr link."""
    kw = dict(channel)
    if "Rspat_config" in kw:
        corr, pol, direction, params = kw["Rspat_config"]
        kw["Rspat_config"] = (corr, pol, direction, tuple(params))
    if "multi_paths" in kw:
        kw["multi_paths"] = [list(p) for p in kw["multi_paths"]]
    return chan_mod.gen_channel_model_config(
        Nt=carrier["num_of_ant"], Nr=carrier["Nr"], **kw)


def ce_config(ce: dict, chan_cfg: dict, scs: int) -> dict:
    """The CE settings the sweep runs with (FO estimation off where the
    Doppler spread makes it unreliable)."""
    out = dict(DEFAULT_CE_CONFIG, **ce)
    if out.get("enable_FO_est") and not fo_est_valid_for_doppler(
            float(chan_cfg.get("fm_inHz", 0) or 0), scs):
        out["enable_FO_est"] = False
        out["enable_FO_comp"] = False
    return out


@contextlib.contextmanager
def _llr_taps(out: dict, bf16: bool, llr_noise: float, seed: int):
    """Record (under bf16 rounded, with llr_noise perturbed) every
    equalizer output of the frozen RX: out[algo] collects the LLR
    tensors in call order."""
    batch_fn = batch_core.equalize_and_demod_traced
    slot_fn = pdsch_rx_mod.channel_equ_and_demod
    gen = None

    def touch(llr):
        nonlocal gen
        if bf16:
            llr = to_bf16(llr)
        if llr_noise:
            if gen is None:
                gen = torch.Generator(device=llr.device).manual_seed(seed)
            llr = llr * (1 + llr_noise * torch.randn(
                llr.shape, generator=gen, device=llr.device))
        return llr

    def batched(y, h, cov, modtype, algo):
        llr = touch(batch_fn(y, h, cov, modtype, algo))
        out.setdefault(algo, []).append(llr)
        return llr

    def per_slot(y, h, cov, modtype, ceq_config, device=None):
        s, nv, hard, llr = slot_fn(y, h, cov, modtype, ceq_config, device)
        llr = touch(llr)
        out.setdefault(ceq_config["algo"], []).append(llr)
        return s, nv, hard, llr

    batch_core.equalize_and_demod_traced = batched
    pdsch_rx_mod.channel_equ_and_demod = per_slot
    try:
        yield
    finally:
        batch_core.equalize_and_demod_traced = batch_fn
        pdsch_rx_mod.channel_equ_and_demod = slot_fn


def point(cfg: dict, traffic: dict, snr_db: float, seed: int,
          trblks: torch.Tensor, device, bf16: bool = False,
          llr_noise: float = 0.0) -> dict:
    """One SNR point of the cell through the frozen chain -> dict(tx=,
    channel=, grid=, llr={algo: (n,)}, ok={algo: (Sa,) bool},
    tbblk={algo: (Sa, A) int8}), tensors on device.

    cfg is the configuration file's dict, traffic the traffic file's;
    seed the point's seed (the benchmark's seed + 7919 * index), trblks
    the (Sa, TBSize) blocks sent in the allocated slots. llr_noise > 0
    multiplies every LLR by 1 + llr_noise * N(0, 1) before the decoder:
    how near its decisions lie to a flip (calibrate.py)."""
    dev = torch.device(device)
    carrier = cfg["carrier"]
    ch_cfg = cfg["channel_config"]
    n_slots = traffic["slots_per_point"]
    algos = traffic["equalizers"]
    scs, bw = carrier["scs"], carrier["BW"]
    fs_hz = fft_size(carrier_prb_size(scs, bw)) * scs * 1000.0
    waveform_config = dict(numofslots=n_slots, startSFN=0, startslot=0,
                           samplerate_in_mhz=fs_hz / 1e6)
    chan_cfg = channel_config(traffic["channel"], carrier)
    rng = np.random.default_rng(seed)
    if cfg["link"] == "DL":
        obj = Pdsch(ch_cfg, carrier, rng=rng, device=dev)
    else:
        obj = NrPUSCH(carrier, ch_cfg, rng=rng, device=dev)
    model = chan_mod.NrChannelModel(
        chan_cfg, -snr_db, carrier["carrier_frequency_in_mhz"] * 1e6,
        fs_hz, scs, seed=seed, device=dev)
    if np.any(model.gen_Dm(n_slots)):
        raise ValueError("the frozen reference has no timing-error path")
    rnd = to_bf16 if bf16 else (lambda x: x)
    gen = dl_wf.gen_dl_waveform if cfg["link"] == "DL" \
        else ul_wf.gen_ul_waveform
    tx = rnd(gen(waveform_config, carrier, obj, trblks=trblks))
    rx = rnd(model.filter(tx))
    grid = rnd(rx_wf.waveform_rx_processing(rx, carrier, fs_hz)[1])

    spf = slots_per_frame(scs)
    slots = [i % spf for i in range(n_slots)]
    alloc = [i for i, s in enumerate(slots)
             if (s % ch_cfg["period_in_slot"]) in ch_cfg["allocated_slots"]]
    ce = ce_config(cfg["ce"], chan_cfg, scs)
    ldpc = dict(DEFAULT_LDPC_CONFIG, **cfg["ldpc"])
    llrs, ok, tbblk = {}, {}, {}
    with _llr_taps(llrs, bf16, llr_noise, seed):
        if traffic["use_batch"]:
            nr_ant = grid.shape[0]
            full = grid.reshape(nr_ant, n_slots, -1).transpose(0, 1)
            stack = full[torch.as_tensor(alloc, device=dev)]
            obj.rvidx = -1
            for algo in algos:
                ok[algo], tbblk[algo] = obj.rx_process_batch(
                    stack, [slots[i] for i in alloc], {"algo": algo}, ldpc,
                    ce, fetch=False)[:2]
        else:
            size = grid.shape[1] // n_slots
            ests = []
            for i in alloc:
                rx_slot = grid[:, i * size: (i + 1) * size]
                h_ls, rs_info = obj.H_LS_est(rx_slot, slots[i])
                est = NrChannelEstimation(h_ls, rs_info, dict(ce))
                H, cov = est.channel_est()
                ests.append((rx_slot, slots[i], H, cov, est))
            for algo in algos:
                obj.rvidx = -1
                outs = [obj.RX_process(rx_slot, slot, {"algo": algo}, H, cov,
                                       ldpc, est)
                        for rx_slot, slot, H, cov, est in ests]
                ok[algo] = torch.stack([torch.as_tensor(o[0]) for o in outs])
                tbblk[algo] = torch.stack([o[1] for o in outs])
    return dict(tx=tx, channel=rx, grid=grid,
                llr={a: torch.cat(v) for a, v in llrs.items()}, ok=ok,
                tbblk=tbblk)
