"""Channel filters: FIR + halfband up/down-sampling chains (DUC/DDC).

Port of python_5gtoolbox_tpu/ops/filters.py. Coefficients are designed
with scipy.signal.remez with the same parameters, hence identical taps.
Every stage is one call of banded_fir on real/imag float32 planes:

  same : y[t] = sum_i x[i] taps[t + n-1-n//2 - i]        (fir_same)
  up2  : y[t] = sqrt2 * sum_i x[i] taps[t + n//2-1 - 2i] (hb_upsample2)
  down2: y[t] = sqrt2 * sum_i x[i] taps[2t + 2((n+1)//4) - i]
                                                        (hb_downsample2)

which are the upfirdn offset conventions of the reference DUC/DDC. On a
CUDA tensor banded_fir launches the hand-written kernel
(csrc/banded_fir.cu); on a CPU tensor it runs banded_fir_plain, the same
function as torch conv1d.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import remez

from python_5gtoolbox_tpu_torch import kernels
from python_5gtoolbox_tpu_torch.utils import numerology as num

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
_HB_NUMTAPS = 55
_HB_FPASS = 0.21

_MODES = {"same": 0, "up2": 1, "down2": 2}


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


@functools.lru_cache(maxsize=None)
def halfband_coeff() -> np.ndarray:
    return remez(_HB_NUMTAPS, [0, _HB_FPASS, 0.5 - _HB_FPASS, 0.5], [1, 0])


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


@functools.lru_cache(maxsize=64)
def _device_taps(taps_key: bytes, scale: float, device: torch.device):
    taps = np.frombuffer(taps_key, np.float64) * scale
    return torch.as_tensor(taps.astype(np.float32), device=device)


def banded_fir(planes: torch.Tensor, taps: np.ndarray,
               mode: str) -> torch.Tensor:
    """One FIR stage on real planes: (P, T) float32 -> (P, T_out).

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_conv_kernel
    (reached through banded_conv). CUDA tensors go through the
    hand-written kernel csrc/banded_fir.cu; CPU tensors through
    banded_fir_plain.
    """
    if planes.device.type == "cpu":
        return banded_fir_plain(planes, taps, mode)
    if planes.device.type != "cuda":
        raise ValueError(f"banded_fir: unsupported device {planes.device}")
    if planes.dtype != torch.float32 or planes.dim() != 2 \
            or not planes.is_contiguous():
        raise ValueError("banded_fir: planes must be a contiguous 2-D "
                         "float32 tensor")
    n = len(taps)
    p, t = planes.shape
    b, t_out, scale = _stage(n, mode, t)
    h = _device_taps(np.ascontiguousarray(taps, np.float64).tobytes(),
                     scale, planes.device)
    y = torch.empty((p, t_out), dtype=torch.float32, device=planes.device)
    fn = kernels.library("banded_fir").banded_fir
    rc = fn(planes.data_ptr(), h.data_ptr(), y.data_ptr(), p, t, t_out, n,
            _MODES[mode], b, torch.cuda.current_stream(planes.device)
            .cuda_stream)
    kernels.check("banded_fir", rc)
    kernels.LAUNCHES["banded_fir"] += 1
    return y


def _complex_stage(x: torch.Tensor, taps: np.ndarray,
                   mode: str) -> torch.Tensor:
    """Complex (..., T) through one stage as 2*prod(...) real planes."""
    lead, t = x.shape[:-1], x.shape[-1]
    xc = x.to(torch.complex64).reshape(-1, t)
    planes = torch.cat([xc.real, xc.imag]).contiguous()
    y = banded_fir(planes, taps, mode)
    m = xc.shape[0]
    return torch.complex(y[:m], y[m:]).reshape(lead + (y.shape[-1],))


def fir_same(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """upfirdn(h, x)[h//2 : h//2+len] == centered 'same' convolution."""
    return _complex_stage(x, taps, "same")


def hb_upsample2(x: torch.Tensor, taps: np.ndarray | None = None
                 ) -> torch.Tensor:
    """upfirdn(h, x, up=2)[h//2-1 : h//2-1+2len] * sqrt(2)."""
    return _complex_stage(x, halfband_coeff() if taps is None else taps,
                          "up2")


def hb_downsample2(x: torch.Tensor, taps: np.ndarray | None = None
                   ) -> torch.Tensor:
    """upfirdn(h, x, down=2)[(n+1)//4 : (n+1)//4 + T//2] * sqrt(2)."""
    return _complex_stage(x, halfband_coeff() if taps is None else taps,
                          "down2")


def _oversample(scs: int, bw: int, rate_hz: float) -> int:
    fs = num.fft_size(num.carrier_prb_size(scs, bw)) * scs * 1000
    oversample = int(round(rate_hz / fs))
    if oversample < 1 or oversample & (oversample - 1):
        raise ValueError(f"rate {rate_hz} Hz is not a power-of-two multiple "
                         f"of the carrier rate {fs} Hz")
    return oversample


def rx_channel_filter(rx: torch.Tensor, scs: int, bw: int,
                      in_rate_hz: float) -> torch.Tensor:
    """DDC: halfband /2 stages then FIR at carrier rate (rx_lowphy:100-164)."""
    y = rx
    for _ in range(int(np.log2(_oversample(scs, bw, in_rate_hz)))):
        y = hb_downsample2(y)
    return fir_same(y, fir_coeff(scs, bw))


def tx_channel_filter(td: torch.Tensor, scs: int, bw: int,
                      out_rate_hz: float = 245.76e6) -> torch.Tensor:
    """(..., T) at carrier rate -> (..., T * oversample) at out_rate_hz."""
    y = fir_same(td, fir_coeff(scs, bw))
    for _ in range(int(np.log2(_oversample(scs, bw, out_rate_hz)))):
        y = hb_upsample2(y)
    return y


def tx_lowphy_duc(fd_ant_major: torch.Tensor, scs: int, bw: int,
                  carrier_freq_hz: int = 0, out_rate_hz: float = 245.76e6,
                  slot_phase: bool = False,
                  start_slot: int = 0) -> torch.Tensor:
    """TX low-PHY + DUC: (ant, slots, 14, n_sc) frequency grids ->
    (ant, oversample * slots * slot_samples) waveform.

    Applies NO antenna ifftshift roll (pre-roll fd for reference parity;
    see ofdm.tx_low_phy roll_ant). This is the composed path of the JAX
    function (tx_low_phy, slot phase, tx_channel_filter); its fused
    DUC kernels for oversample >= 2 are not ported yet.
    """
    from python_5gtoolbox_tpu_torch.ops import ofdm

    nant, n_slots = fd_ant_major.shape[0], fd_ant_major.shape[1]
    td = ofdm.tx_low_phy(fd_ant_major, scs, bw, carrier_freq_hz,
                         roll_ant=False)
    if slot_phase:
        ph = ofdm._slot_phase_const(scs, carrier_freq_hz, n_slots,
                                    start_slot)
        td = td * torch.as_tensor(ph, device=td.device)[None, :, None]
    return tx_channel_filter(td.reshape(nant, -1), scs, bw, out_rate_hz)
