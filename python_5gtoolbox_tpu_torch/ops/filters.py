"""Channel filters: FIR + halfband up/down-sampling chains (DUC/DDC).

Port of python_5gtoolbox_tpu/ops/filters.py and of the entry points of
python_5gtoolbox_tpu/ops/pallas_filters.py. Coefficients are designed
with scipy.signal.remez with the same parameters, hence identical taps.
Single stages are one call of banded_fir on real/imag float32 planes:

  same : y[t] = sum_i x[i] taps[t + n-1-n//2 - i]        (fir_same)
  up2  : y[t] = sqrt2 * sum_i x[i] taps[t + n//2-1 - 2i] (hb_upsample2)
  down2: y[t] = sqrt2 * sum_i x[i] taps[2t + 2((n+1)//4) - i]
                                                        (hb_downsample2)

which are the upfirdn offset conventions of the reference DUC/DDC. The
DUC's first two stages (FIR `same`, then halfband `up2`) run fused, with
the 1x-rate intermediate kept on chip, in three forms: from a flat plane
(fir_up2_fused_planes), from per-symbol IFFT outputs with the CP
inserted on the way (fir_up2_fused_symbols), and from the padded
spectrum with the IDFT and the phase compensation computed too
(duc_from_spec_planes). The serial pipeline truncates fir_same to
[0, T) before the halfband sees it, so the fused forms zero the FIR
outputs outside [0, T) between the stages; that is not the same as
filtering a zero-padded input through both.

Every wrapper launches its hand-written CUDA kernel (csrc/*.cu) on a
CUDA tensor, whatever the length, and runs its *_plain version (torch
conv1d / torch.fft) on a CPU tensor.
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
    h = _device_taps(_taps_key(taps), scale, planes.device)
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


def banded_conv_planes(planes: torch.Tensor, taps: np.ndarray,
                       mode: str) -> torch.Tensor:
    """Planar (P, T) float32 entry for one stage -> (P, T_out)."""
    return banded_fir(planes, taps, mode)


# ---------------------------------------------------------------------------
# Fused DUC stages: FIR `same` + halfband `up2`
# ---------------------------------------------------------------------------

def _check_planes(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: input must be a contiguous {ndim}-D "
                         f"float32 tensor")


def _taps_key(taps: np.ndarray) -> bytes:
    return np.ascontiguousarray(taps, np.float64).tobytes()


def _fused_taps(fir_taps: np.ndarray, hb_taps: np.ndarray, device):
    """(FIR taps, halfband taps * sqrt 2) as float32 tensors on device."""
    return (_device_taps(_taps_key(fir_taps), 1.0, device),
            _device_taps(_taps_key(hb_taps), float(np.sqrt(2)), device))


@functools.lru_cache(maxsize=64)
def _device_ints(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int32), device=device)


@functools.lru_cache(maxsize=64)
def _device_floats(key: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(key, np.float32).copy(),
                           device=device)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fir_up2_fused_plain(planes: torch.Tensor, fir_taps: np.ndarray,
                        hb_taps: np.ndarray) -> torch.Tensor:
    """Plain-torch fused pair: (P, T) float32 -> (P, 2T). banded_fir_plain
    'same' returns exactly [0, T), which is the mask between the stages."""
    return banded_fir_plain(banded_fir_plain(planes, fir_taps, "same"),
                            hb_taps, "up2")


def fir_up2_fused_planes(planes: torch.Tensor, fir_taps: np.ndarray,
                         hb_taps: np.ndarray) -> torch.Tensor:
    """FIR `same` + halfband `up2` on real planes in one kernel:
    (P, T) float32 -> (P, 2T).

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_fused_kernel
    (entries fir_up2_fused_planes and fir_up2_fused; no pre-padding is
    needed here). CUDA tensors go through csrc/fir_up2_fused.cu; CPU
    tensors through fir_up2_fused_plain.
    """
    if planes.device.type == "cpu":
        return fir_up2_fused_plain(planes, fir_taps, hb_taps)
    _check_planes("fir_up2_fused", planes, 2)
    p, t = planes.shape
    h, g = _fused_taps(fir_taps, hb_taps, planes.device)
    z = torch.empty((p, 2 * t), dtype=torch.float32, device=planes.device)
    fn = kernels.library("fir_up2_fused").fir_up2_fused
    rc = fn(planes.data_ptr(), h.data_ptr(), g.data_ptr(), z.data_ptr(), p,
            t, len(fir_taps), len(hb_taps), _stream(planes))
    kernels.check("fir_up2_fused", rc)
    kernels.LAUNCHES["fir_up2_fused"] += 1
    return z


def fir_up2_fused(x: torch.Tensor, fir_taps: np.ndarray,
                  hb_taps: np.ndarray) -> torch.Tensor:
    """hb_upsample2(fir_same(x, fir_taps), hb_taps) on complex (..., T)
    in one fused kernel -> complex64 (..., 2T)."""
    lead, t = x.shape[:-1], x.shape[-1]
    xc = x.to(torch.complex64).reshape(-1, t)
    planes = torch.cat([xc.real, xc.imag]).contiguous()
    y = fir_up2_fused_planes(planes, fir_taps, hb_taps)
    m = xc.shape[0]
    return torch.complex(y[:m], y[m:]).reshape(lead + (2 * t,))


def fir_up2_fused_symbols_plain(sym_planes: torch.Tensor, cps,
                                fir_taps: np.ndarray,
                                hb_taps: np.ndarray) -> torch.Tensor:
    """Plain-torch version: CP concat, then fir_up2_fused_plain."""
    from python_5gtoolbox_tpu_torch.ops import ofdm
    flat = ofdm.cp_concat(sym_planes, cps).reshape(sym_planes.shape[0], -1)
    return fir_up2_fused_plain(flat, fir_taps, hb_taps)


def fir_up2_fused_symbols(sym_planes: torch.Tensor, cps,
                          fir_taps: np.ndarray,
                          hb_taps: np.ndarray) -> torch.Tensor:
    """CP insertion + FIR + halfband `up2` in one kernel: (P, S, 14, nfft)
    float32 symbol planes -> (P, 2*S*slot_samples) float32.

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_fused_sym_kernel
    (entry fir_up2_fused_symbols). CUDA tensors go through
    csrc/fir_up2_fused_symbols.cu; CPU tensors through
    fir_up2_fused_symbols_plain.
    """
    cps = tuple(int(c) for c in cps)
    if sym_planes.device.type == "cpu":
        return fir_up2_fused_symbols_plain(sym_planes, cps, fir_taps,
                                           hb_taps)
    _check_planes("fir_up2_fused_symbols", sym_planes, 4)
    p, s, n_sym, nfft = sym_planes.shape
    if n_sym != 14 or len(cps) != 14 or max(cps) > nfft or min(cps) < 0:
        raise ValueError("fir_up2_fused_symbols: needs 14 symbols per slot "
                         "and 14 CP lengths within [0, nfft]")
    slot_samples = sum(cps) + 14 * nfft
    dev = sym_planes.device
    h, g = _fused_taps(fir_taps, hb_taps, dev)
    z = torch.empty((p, 2 * s * slot_samples), dtype=torch.float32,
                    device=dev)
    fn = kernels.library("fir_up2_fused_symbols").fir_up2_fused_symbols
    rc = fn(sym_planes.data_ptr(), _device_ints(cps, dev).data_ptr(),
            h.data_ptr(), g.data_ptr(), z.data_ptr(), p, s, nfft,
            slot_samples, len(fir_taps), len(hb_taps), _stream(sym_planes))
    kernels.check("fir_up2_fused_symbols", rc)
    kernels.LAUNCHES["fir_up2_fused_symbols"] += 1
    return z


def _spec_symbols_plain(spec_planes: torch.Tensor,
                        phase_comp: np.ndarray) -> torch.Tensor:
    """(2*ant, S, 14, nfft) spectrum planes -> symbol planes of the same
    shape: centre-ifftshifted IDFT * sqrt(nfft) with torch.fft, times the
    per-symbol phase compensation."""
    nant, nfft = spec_planes.shape[0] // 2, spec_planes.shape[-1]
    spec = torch.complex(spec_planes[:nant], spec_planes[nant:])
    sign = np.ones(nfft, np.float32)
    sign[1::2] = -1.0
    sp = (sign * np.sqrt(nfft)).astype(np.complex64)[None, :] \
        * np.asarray(phase_comp, np.complex64)[:, None]
    td = torch.fft.ifft(spec, dim=-1) * torch.as_tensor(sp,
                                                        device=spec.device)
    return torch.cat([td.real, td.imag], dim=0).contiguous()


def duc_from_spec_planes_plain(spec_planes: torch.Tensor, cps,
                               fir_taps: np.ndarray, hb_taps: np.ndarray,
                               phase_comp: np.ndarray
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch version: torch.fft IDFT, sign, sqrt(nfft), phase
    compensation, then fir_up2_fused_symbols_plain."""
    nant = spec_planes.shape[0] // 2
    y = fir_up2_fused_symbols_plain(
        _spec_symbols_plain(spec_planes, phase_comp), cps, fir_taps, hb_taps)
    return y[:nant], y[nant:]


@functools.lru_cache(maxsize=8)
def _twiddles(nfft: int) -> bytes:
    q = 2 * np.pi * np.arange(nfft // 2) / nfft
    return np.concatenate([np.cos(q), np.sin(q)]).astype(np.float32).tobytes()


def _duc_from_spec(spec_planes: torch.Tensor, cps, fir_taps: np.ndarray,
                   hb_taps: np.ndarray, phase_comp: np.ndarray
                   ) -> torch.Tensor:
    """duc_from_spec_planes with both output planes in one (2*ant, T2)
    tensor (real planes first)."""
    cps = tuple(int(c) for c in cps)
    if spec_planes.device.type == "cpu":
        return torch.cat(duc_from_spec_planes_plain(
            spec_planes, cps, fir_taps, hb_taps, phase_comp))
    _check_planes("duc_from_spec_planes", spec_planes, 4)
    p2, s, n_sym, nfft = spec_planes.shape
    if n_sym != 14 or len(cps) != 14 or p2 % 2 or nfft & (nfft - 1) \
            or max(cps) > nfft or min(cps) < 0 or len(phase_comp) != 14:
        raise ValueError("duc_from_spec_planes: needs (2*ant, S, 14, nfft) "
                         "planes with nfft a power of two, 14 CP lengths "
                         "within [0, nfft] and 14 phase factors")
    slot_samples = sum(cps) + 14 * nfft
    dev = spec_planes.device
    h, g = _fused_taps(fir_taps, hb_taps, dev)
    pc = np.asarray(phase_comp, np.complex64)
    pc = np.stack([pc.real, pc.imag], axis=1).astype(np.float32)
    z = torch.empty((p2, 2 * s * slot_samples), dtype=torch.float32,
                    device=dev)
    fn = kernels.library("duc_from_spec").duc_from_spec
    rc = fn(spec_planes.data_ptr(), _device_ints(cps, dev).data_ptr(),
            _device_floats(pc.tobytes(), dev).data_ptr(),
            _device_floats(_twiddles(nfft), dev).data_ptr(), h.data_ptr(),
            g.data_ptr(), z.data_ptr(), p2 // 2, s, nfft, slot_samples,
            min(cps), max(cps), len(fir_taps), len(hb_taps),
            _stream(spec_planes))
    kernels.check("duc_from_spec", rc)
    kernels.LAUNCHES["duc_from_spec"] += 1
    return z


def duc_from_spec_planes(spec_planes: torch.Tensor, cps,
                         fir_taps: np.ndarray, hb_taps: np.ndarray,
                         phase_comp: np.ndarray
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """IDFT + phase compensation + CP + FIR + halfband `up2` in one
    kernel: (2*ant, S, 14, nfft) float32 padded-spectrum planes (real
    planes first, ofdm.tx_spec_planes) -> (re, im) planes, each
    (ant, 2*S*slot_samples).

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_fused_spec_kernel
    (entry duc_from_spec_planes). CUDA tensors go through
    csrc/duc_from_spec.cu, which computes the IDFT in its own body; CPU
    tensors through duc_from_spec_planes_plain.
    """
    z = _duc_from_spec(spec_planes, cps, fir_taps, hb_taps, phase_comp)
    nant = z.shape[0] // 2
    return z[:nant], z[nant:]


def _planes_out(y: torch.Tensor, nant: int, as_planes):
    """(2*ant, T) planes (real first) in the form as_planes asks for."""
    if as_planes == "split":
        return y[:nant], y[nant:]
    if as_planes:
        return y
    return torch.complex(y[:nant], y[nant:])


def tx_channel_filter(td: torch.Tensor, scs: int, bw: int,
                      out_rate_hz: float = 245.76e6) -> torch.Tensor:
    """(..., T) at carrier rate -> (..., T * oversample) at out_rate_hz:
    the FIR and the first halfband stage fused (fir_up2_fused) when
    oversample >= 2, further halfband stages one by one."""
    n_hb = int(np.log2(_oversample(scs, bw, out_rate_hz)))
    if n_hb == 0:
        return fir_same(td, fir_coeff(scs, bw))
    y = fir_up2_fused(td, fir_coeff(scs, bw), halfband_coeff())
    for _ in range(n_hb - 1):
        y = hb_upsample2(y)
    return y


def tx_lowphy_duc(fd_ant_major: torch.Tensor, scs: int, bw: int,
                  carrier_freq_hz: int = 0, out_rate_hz: float = 245.76e6,
                  as_planes=False, slot_phase: bool = False,
                  start_slot: int = 0):
    """TX low-PHY + DUC: (ant, slots, 14, n_sc) frequency grids ->
    (ant, oversample * slots * slot_samples) complex64 waveform.

    Applies NO antenna ifftshift roll (pre-roll fd for reference parity;
    see ofdm.tx_low_phy roll_ant). With oversample >= 2 the chain runs
    planar through one fused kernel: from the padded spectrum
    (duc_from_spec_planes) when nfft >= 1024, from the IFFT outputs
    (fir_up2_fused_symbols) below, then the remaining halfband stages
    through banded_fir. At the carrier rate it is the composed path
    tx_low_phy, slot phase, FIR. as_planes=True returns (2*ant, T) float32
    planes (real planes first), as_planes="split" the pair (re, im).
    """
    from python_5gtoolbox_tpu_torch.ops import ofdm

    nant, n_slots = fd_ant_major.shape[0], fd_ant_major.shape[1]
    n_hb = int(np.log2(_oversample(scs, bw, out_rate_hz)))
    if n_hb == 0:
        td = ofdm.tx_low_phy(fd_ant_major, scs, bw, carrier_freq_hz,
                             roll_ant=False)
        if slot_phase:
            ph = ofdm._slot_phase_const(scs, carrier_freq_hz, n_slots,
                                        start_slot)
            td = td * torch.as_tensor(ph, device=td.device)[None, :, None]
        out = tx_channel_filter(td.reshape(nant, -1), scs, bw, out_rate_hz)
        if not as_planes:
            return out
        return _planes_out(torch.cat([out.real, out.imag]), nant, as_planes)
    nfft = num.fft_size(num.carrier_prb_size(scs, bw))
    cps = ofdm._cp_table(scs, nfft)
    if nfft >= 1024:
        spec = ofdm.tx_spec_planes(fd_ant_major, scs, bw, carrier_freq_hz,
                                   slot_phase=slot_phase,
                                   start_slot=start_slot)
        y = _duc_from_spec(spec, cps, fir_coeff(scs, bw), halfband_coeff(),
                           ofdm._phase_comp(scs, nfft, carrier_freq_hz))
    else:
        symp = ofdm.tx_low_phy_sym_planes(fd_ant_major, scs, bw,
                                          carrier_freq_hz,
                                          slot_phase=slot_phase,
                                          start_slot=start_slot)
        y = fir_up2_fused_symbols(symp, cps, fir_coeff(scs, bw),
                                  halfband_coeff())
    for _ in range(n_hb - 1):
        y = banded_conv_planes(y, halfband_coeff(), "up2")
    return _planes_out(y, nant, as_planes)
