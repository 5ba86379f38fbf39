"""Channel filters at the carrier rate, plain PyTorch (frozen copy).

A frozen copy of the port's ops/filters.py, cut to what the link-level
cells run: the channel FIR as one centred 'same' convolution per real
plane (torch conv1d), on the TX after OFDM and on the RX before it. The
port runs the same filter through its hand-written banded_fir kernel;
here it is always the plain convolution, on whatever device the planes
are on (TF32 must be off: the caller sets that).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import remez

from portbench.reference.frozen.utils import numerology as num

# FIR tap counts from the reference's offline filter search
# (tx_lowphy_process.py:108-122).
_FIR_NUMTAPS = {
    (30, 100): 287, (30, 90): 287, (30, 80): 287, (30, 70): 287,
    (30, 60): 287, (30, 50): 143, (30, 45): 143, (30, 40): 143,
    (30, 35): 143, (30, 30): 143, (30, 25): 71, (30, 20): 71,
    (30, 15): 87, (30, 10): 45, (30, 5): 27, (15, 5): 51, (15, 10): 87,
    (15, 15): 153, (15, 20): 143, (15, 25): 143, (15, 30): 287,
    (15, 35): 287, (15, 40): 287, (15, 45): 287, (15, 50): 287,
}


@functools.lru_cache(maxsize=None)
def fir_coeff(scs: int, bw: int) -> np.ndarray:
    """Channel-filter FIR taps at the carrier native rate (plan time)."""
    prb = num.carrier_prb_size(scs, bw)
    nfft = num.fft_size(prb)
    fs = nfft * scs * 1000
    fpass = ((prb * 12 * scs + scs / 2) * 1000) / 2
    fstop = bw * 1e6 / 2
    numtaps = _FIR_NUMTAPS.get((scs, bw), 287)
    return remez(numtaps, [0, fpass, fstop, fs / 2], [1, 0], fs=fs)


def _stage(n: int, mode: str, t: int) -> tuple[int, int, float]:
    """(b, t_out, tap scale) of one stage over n taps and t inputs."""
    if mode == "same":
        return n - 1 - n // 2, t, 1.0
    if mode == "up2":
        return n // 2 - 1, 2 * t, float(np.sqrt(2))
    if mode == "down2":
        return 2 * ((n + 1) // 4), t // 2, float(np.sqrt(2))
    raise ValueError(f"unknown mode {mode!r}")


def banded_fir_plain(planes: torch.Tensor, taps: np.ndarray,
                     mode: str) -> torch.Tensor:
    """Plain-torch banded_fir: (P, T) float32 -> (P, T_out) float32 with
    torch conv1d (cross-correlation, so the taps are flipped)."""
    n = len(taps)
    _, _, scale = _stage(n, mode, planes.shape[-1])
    k = torch.as_tensor(np.ascontiguousarray(taps[::-1]), dtype=torch.float32,
                        device=planes.device).view(1, 1, n)
    x = planes.to(torch.float32).unsqueeze(1)            # (P, 1, T)
    if mode == "same":
        y = F.conv1d(F.pad(x, (n // 2, n - 1 - n // 2)), k)
    elif mode == "up2":
        off = n // 2 - 1
        z = x.new_zeros(x.shape[:-1] + (2 * x.shape[-1] - 1,))
        z[..., ::2] = x
        y = F.conv1d(F.pad(z, ((n - 1) - off, 1 + off)), k)
    else:
        shift = 2 * ((n + 1) // 4)
        y = F.conv1d(F.pad(x, ((n - 1) - shift, shift - 1)), k, stride=2)
    y = y[:, 0]
    return y * np.float32(scale) if scale != 1.0 else y


def _complex_stage(x: torch.Tensor, taps: np.ndarray,
                   mode: str) -> torch.Tensor:
    """Complex (..., T) through one stage as 2*prod(...) real planes."""
    lead, t = x.shape[:-1], x.shape[-1]
    xc = x.to(torch.complex64).reshape(-1, t)
    planes = torch.cat([xc.real, xc.imag]).contiguous()
    y = banded_fir_plain(planes, taps, mode)
    m = xc.shape[0]
    return torch.complex(y[:m], y[m:]).reshape(lead + (y.shape[-1],))


def fir_same(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """upfirdn(h, x)[h//2 : h//2+len] == centered 'same' convolution."""
    return _complex_stage(x, taps, "same")


def _oversample(scs: int, bw: int, rate_hz: float) -> int:
    fs = num.fft_size(num.carrier_prb_size(scs, bw)) * scs * 1000
    oversample = int(round(rate_hz / fs))
    if oversample != 1:
        raise ValueError("the frozen reference runs at the carrier rate only")
    return oversample


def rx_channel_filter(rx: torch.Tensor, scs: int, bw: int,
                      in_rate_hz: float) -> torch.Tensor:
    """RX channel FIR at the carrier rate."""
    _oversample(scs, bw, in_rate_hz)
    return fir_same(rx, fir_coeff(scs, bw))


def tx_lowphy_duc(fd_ant_major: torch.Tensor, scs: int, bw: int,
                  carrier_freq_hz: int = 0, out_rate_hz: float = 245.76e6,
                  slot_phase: bool = False, start_slot: int = 0):
    """TX low-PHY at the carrier rate: (ant, slots, 14, n_sc) frequency
    grids -> OFDM, slot phase, channel FIR -> (ant, slots * slot_samples)
    complex64."""
    from portbench.reference.frozen.ops import ofdm

    nant, n_slots = fd_ant_major.shape[0], fd_ant_major.shape[1]
    _oversample(scs, bw, out_rate_hz)
    td = ofdm.tx_low_phy(fd_ant_major, scs, bw, carrier_freq_hz,
                         roll_ant=False)
    if slot_phase:
        ph = ofdm._slot_phase_const(scs, carrier_freq_hz, n_slots,
                                    start_slot)
        td = td * torch.as_tensor(ph, device=td.device)[None, :, None]
    return fir_same(td.reshape(nant, -1), fir_coeff(scs, bw))
