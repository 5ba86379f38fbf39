"""OFDM Tx/Rx low-PHY: IFFT + CP + phase compensation, TS 38.211 5.3.1.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/ofdm.py (tx_low_phy, rx_low_phy, the
planar antenna-major TX entries that feed the fused DUC kernels, and
their plan-time tables): center-mapped ifftshift IFFT with sqrt(N)
scaling, CP prepend and per-symbol carrier phase compensation on TX;
the half-CP-advanced FFT window on RX. Slots are a leading batch axis and
all 14 symbols go through one batched torch.fft call.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.frozen.utils import numerology as num


@functools.lru_cache(maxsize=None)
def _cp_table(scs: int, nfft: int) -> np.ndarray:
    if scs == 15:
        base = np.array([320] + [288] * 6 + [320] + [288] * 6)
    else:
        base = np.array([352] + [288] * 13)
    return (base * nfft // 4096).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _phase_comp(scs: int, nfft: int, carrier_freq_hz: int) -> np.ndarray:
    """Per-symbol phase compensation e^{-j2πΔ(t_off+CP)} (tx_lowphy:72-75)."""
    cps = _cp_table(scs, nfft)
    fs = nfft * scs * 1000
    out = np.ones(14, np.complex64)
    if carrier_freq_hz:
        delta = carrier_freq_hz / fs
        off = 0
        for m in range(14):
            out[m] = np.exp(-1j * 2 * np.pi * delta * (off + cps[m]))
            off += cps[m] + nfft
    return out


@functools.lru_cache(maxsize=None)
def _slot_phase_const(scs: int, carrier_freq_hz: int, n_slots: int,
                      start_slot: int) -> np.ndarray:
    """Per-slot phase compensation e^{-j2pi fc t_slot}
    (nr_dl_waveform.py:91-100)."""
    idx = start_slot + np.arange(n_slots)
    if not carrier_freq_hz:
        return np.ones(n_slots, np.complex64)
    per_ms = carrier_freq_hz / 1e3
    slot_ms = 1.0 if scs == 15 else 0.5
    return np.exp(-1j * 2 * np.pi * per_ms * slot_ms * idx
                  ).astype(np.complex64)


def tx_low_phy(fd_slots: torch.Tensor, scs: int, bw: int,
               carrier_freq_hz: int = 0, dm: torch.Tensor | None = None,
               nfft: int | None = None, roll_ant: bool = True
               ) -> torch.Tensor:
    """(..., ant, 14, n_sc) frequency grid -> (..., ant, slot_samples).

    dm: optional (..., 14) per-symbol fractional timing error (seconds)
    applied as a frequency-domain phase ramp. roll_ant reproduces the
    reference's ifftshift over all axes, which also rolls the antenna
    axis by nant//2 (undone by rx_low_phy).
    """
    n_sc = fd_slots.shape[-1]
    dev = fd_slots.device
    if nfft is None:
        nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    x = fd_slots.to(torch.complex64)
    if dm is not None:
        k = torch.arange(n_sc, dtype=torch.float32, device=dev)
        ang = 2 * np.pi * k * (scs * 1000.0) \
            * dm[..., None, :, None].to(torch.float32)
        x = x * torch.polar(torch.ones_like(ang), ang)
    lo = (nfft - n_sc) // 2
    spec = torch.nn.functional.pad(x, (lo, nfft - n_sc - lo))
    nant = spec.shape[-3]
    if roll_ant and nant > 1:
        spec = torch.roll(spec, -(nant // 2), dims=-3)
    # ifftshift folded into a (-1)^m sign on the output (even nfft)
    td = torch.fft.ifft(spec, dim=-1)
    sign = np.ones(nfft, np.float32)
    sign[1::2] = -1.0
    scale = (sign * np.sqrt(nfft)).astype(np.complex64)[None, :] \
        * _phase_comp(scs, nfft, carrier_freq_hz)[:, None]
    td = td * torch.as_tensor(scale, device=dev)
    return cp_concat(td, _cp_table(scs, nfft))


def cp_concat(syms: torch.Tensor, cps) -> torch.Tensor:
    """(..., 14, nfft) symbols -> (..., slot_samples): each symbol preceded
    by its last cps[m] samples."""
    nfft = syms.shape[-1]
    parts = []
    for m in range(14):
        sym = syms[..., m, :]
        parts.append(sym[..., nfft - int(cps[m]):])
        parts.append(sym)
    return torch.cat(parts, dim=-1)


def rx_low_phy(td_slots: torch.Tensor, scs: int, bw: int,
               carrier_freq_hz: int = 0, nfft: int | None = None,
               n_sc: int | None = None) -> torch.Tensor:
    """(..., ant, slot_samples) -> (..., ant, 14, n_sc) frequency grid.

    Uses the reference's half-CP-advanced FFT window and undoes the CP/2
    advance with a frequency-domain phase ramp (rx_lowphy_process.py:72-94).
    """
    dev = td_slots.device
    if nfft is None:
        nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    if n_sc is None:
        n_sc = 12 * num.carrier_prb_size(scs, bw)
    cps = _cp_table(scs, nfft)
    half = int(cps[1]) // 2
    wins = []
    off = 0
    for m in range(14):
        cp = int(cps[m])
        start = off + cp - half
        wins.append(td_slots[..., start: start + nfft])
        off += cp + nfft
    win = torch.stack(wins, dim=-2).to(torch.complex64)
    pc = np.conj(_phase_comp(scs, nfft, carrier_freq_hz))[:, None]
    win = win * torch.as_tensor(pc, device=dev)
    spec = torch.fft.fft(win, dim=-1) / np.sqrt(nfft)
    spec = torch.fft.fftshift(spec, dim=-1)
    nant = spec.shape[-3]
    if nant > 1:
        spec = torch.roll(spec, nant // 2, dims=-3)
    lo = (nfft - n_sc) // 2
    spec = spec[..., lo: lo + n_sc]
    ramp = np.exp(1j * 2 * np.pi * half * (lo + np.arange(n_sc)) / nfft)
    return (spec * torch.as_tensor(ramp.astype(np.complex64), device=dev)
            ).to(torch.complex64)
