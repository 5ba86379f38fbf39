"""OFDM Tx/Rx low-PHY: IFFT + CP + phase compensation, TS 38.211 5.3.1.

Port of python_5gtoolbox_tpu/ops/ofdm.py (tx_low_phy, rx_low_phy, the
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

from python_5gtoolbox_tpu_torch.utils import numerology as num


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


def slot_sample_count(scs: int, bw: int) -> int:
    nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    return int(_cp_table(scs, nfft).sum()) + 14 * nfft


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


def _padded_spec(fd_slots: torch.Tensor, scs: int, bw: int,
                 carrier_freq_hz: int, nfft: int | None, slot_phase: bool,
                 start_slot: int) -> tuple[torch.Tensor, int]:
    """(ant, slots, 14, n_sc) grid -> ((ant, slots, 14, nfft) complex64
    centre-padded spectrum, nfft), the slot phase folded in before the
    IFFT (it is linear) when slot_phase is set."""
    n_sc = fd_slots.shape[-1]
    if nfft is None:
        nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    x = fd_slots.to(torch.complex64)
    if slot_phase:
        ph = _slot_phase_const(scs, carrier_freq_hz, fd_slots.shape[1],
                               start_slot)
        x = x * torch.as_tensor(ph, device=x.device)[None, :, None, None]
    lo = (nfft - n_sc) // 2
    return torch.nn.functional.pad(x, (lo, nfft - n_sc - lo)), nfft


def tx_low_phy_sym_planes(fd_slots: torch.Tensor, scs: int, bw: int,
                          carrier_freq_hz: int = 0, nfft: int | None = None,
                          slot_phase: bool = False, start_slot: int = 0,
                          idft: str = "fft") -> torch.Tensor:
    """Antenna-major per-symbol tx_low_phy: (ant, slots, 14, n_sc) complex
    -> (2*ant, slots, 14, nfft) float32 planes (real planes first) of the
    scaled, phase-compensated IFFT outputs, without CP insertion: the CP
    is assembled inside filters.fir_up2_fused_symbols.

    idft is accepted for signature parity; the JAX package's 'matmul'
    two-stage DFT is a substitute for its FFT custom call and computes the
    same values, so both settings go through torch.fft here.
    """
    if idft not in ("fft", "matmul"):
        raise ValueError(f"unknown idft {idft!r}")
    spec, nfft = _padded_spec(fd_slots, scs, bw, carrier_freq_hz, nfft,
                              slot_phase, start_slot)
    td = torch.fft.ifft(spec, dim=-1)
    sign = np.ones(nfft, np.float32)
    sign[1::2] = -1.0
    sp = (sign * np.sqrt(nfft)).astype(np.complex64)[None, :] \
        * _phase_comp(scs, nfft, carrier_freq_hz)[:, None]
    td = td * torch.as_tensor(sp, device=td.device)
    return torch.cat([td.real, td.imag], dim=0).contiguous()


def tx_low_phy_planes(fd_slots: torch.Tensor, scs: int, bw: int,
                      carrier_freq_hz: int = 0, nfft: int | None = None,
                      pad: tuple[int, int] = (0, 0),
                      slot_phase: bool = False,
                      start_slot: int = 0) -> torch.Tensor:
    """Antenna-major planar tx_low_phy: (ant, slots, 14, n_sc) complex ->
    (2*ant, pad[0] + slots*slot_samples + pad[1]) float32 planes (real
    planes first), zero-padded by `pad`. Same values as
    tx_low_phy(roll_ant=False); callers that need the reference's antenna
    roll apply it to fd_slots beforehand."""
    symp = tx_low_phy_sym_planes(fd_slots, scs, bw, carrier_freq_hz, nfft,
                                 slot_phase, start_slot)
    flat = cp_concat(symp, _cp_table(scs, symp.shape[-1]))
    return torch.nn.functional.pad(flat.reshape(symp.shape[0], -1),
                                   tuple(pad))


def tx_spec_planes(fd_slots: torch.Tensor, scs: int, bw: int,
                   carrier_freq_hz: int = 0, nfft: int | None = None,
                   slot_phase: bool = False,
                   start_slot: int = 0) -> torch.Tensor:
    """(ant, slots, 14, n_sc) complex grid -> (2*ant, slots, 14, nfft)
    float32 padded-spectrum planes (real planes first) for
    filters.duc_from_spec_planes, which computes the IDFT itself. Only the
    centre padding, the optional slot-phase fold and the complex->planar
    split happen here. (The JAX function returns the same memory viewed
    as (2*ant, slots, 14*nfft/128, 128).)"""
    spec, _ = _padded_spec(fd_slots, scs, bw, carrier_freq_hz, nfft,
                           slot_phase, start_slot)
    return torch.cat([spec.real, spec.imag], dim=0).contiguous()


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
