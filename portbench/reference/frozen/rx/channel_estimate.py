"""Per-slot channel estimation: timing/frequency offset + DFT/DCT CE.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/rx/channel_estimate.py (reference:
py5gphy/channel_estimate/nr_channel_estimation.py and dft_dct_CE.py,
dft_dct_symmetric_CE.py), computed in torch on the slot's device. It
follows the NumPy class, not the slot-batched rx/ce_batch.py: the
frequency offset is estimated on the peak (Nr, Nt) pair after its timing
compensation (the class keeps a view of H_LS), and the denoising
transform pair runs in complex128, as NumPy promotes it. The helpers
whose math is the same are shared with rx/ce_batch.py (FO compensation,
covariance, time interpolation, DCT matrix).

A frequency offset estimated on the device stays a tensor; only
process_pdsch_data reads it on the host (one synchronisation per slot,
where FO compensation is on), because the reference branches on it.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.frozen import on_device
from portbench.reference.frozen.rx import ce_batch
from portbench.reference.frozen.utils.numerology import symbol_timing_offsets

# Above f_m = FO_EST_FM_LIMIT_FRACTION * scs_hz the FO estimator's
# Doppler-induced error dominates any real CFO it could correct (see
# NrChannelEstimation.freq_offset_est); the sims clamp FO est off.
FO_EST_FM_LIMIT_FRACTION = 0.002

_NFFT = 4096


def fo_est_valid_for_doppler(fm_hz: float, scs: int) -> bool:
    """True if freq_offset_est's error floor is acceptable at this f_m."""
    return fm_hz <= FO_EST_FM_LIMIT_FRACTION * scs * 1000.0


def _cis(ang: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(ang), ang)


def _lsq_extend(x: np.ndarray, y: torch.Tensor, x_new: np.ndarray):
    """Batched deg-1 least squares (float64 weights): y (B, n) over x
    (n,), evaluated at x_new (m,) -> (B, m)."""
    w, xm, xn = ce_batch.lsq_weights(tuple(np.asarray(x).tolist()),
                                     tuple(np.asarray(x_new).tolist()),
                                     torch.float64, y.device)
    slope = y @ w.to(y.dtype)
    intercept = y.mean(dim=1) - slope * xm
    return intercept[:, None] + slope[:, None] * xn


def dft_dct_channel_estimate(H_LS: torch.Tensor, RS_info: dict,
                             CE_config: dict, model: str = "DFT",
                             symmetric: bool = False):
    """Denoising channel estimate of H_LS (sym, RE, Nr, Nt) -> (H (14,
    RE*rd, Nr, Nt), cov (14, PRB, Nr, Nr)), complex64 on H_LS's device
    (numpy goes to the card). symmetric=True mirror-extends before the
    transform with L_right = L_left capped at size//3 + size//16
    (dft_dct_symmetric_CE)."""
    H_LS = on_device(H_LS).to(torch.complex64)
    rd = RS_info["RE_distance"]
    scs = RS_info["scs"]
    ek = CE_config["eRB"] * 12 // rd
    sym_num, re_num, nr, nt = H_LS.shape
    right_ek = ek + (re_num + ek) % 2
    if re_num * rd // 12 <= 1:
        raise ValueError("one-PRB assignment unsupported")

    cols = H_LS.movedim(1, -1).reshape(-1, re_num).to(torch.complex128)
    n_edge = 2 * 12 // rd
    ext = torch.cat([
        _lsq_extend(np.arange(n_edge), cols[:, :n_edge], np.arange(-ek, 0)),
        cols,
        _lsq_extend(np.arange(re_num - n_edge, re_num), cols[:, -n_edge:],
                    np.arange(re_num, re_num + right_ek))], dim=1)
    if symmetric:
        ext = torch.cat([ext, ext.flip(-1)], dim=1)
    L = ext.shape[-1]
    if model == "DFT":
        h_sym = torch.fft.ifft(torch.fft.ifftshift(ext, dim=-1), dim=-1) \
            * np.sqrt(L)
    else:
        h_sym = ce_batch.dct_ortho(ext)
    fs_tap = scs * 1000 * rd * L
    l_l = int(CE_config["L_symm_left_in_ns"] * 1e-9 * fs_tap)
    if symmetric:
        l_l = min(L // 3 + L // 16, l_l)
        l_r = l_l
    else:
        l_r = int(CE_config["L_symm_right_in_ns"] * 1e-9 * fs_tap)
    noise_p = (h_sym[:, l_l: L - l_r].abs() ** 2).mean(dim=-1, keepdim=True)
    h_sym = torch.where(h_sym.abs() < torch.sqrt(noise_p / 2),
                        torch.zeros_like(h_sym), h_sym)
    h_sym[:, l_l: L - l_r] = 0
    if model == "DFT":
        fd = torch.fft.fftshift(torch.fft.fft(h_sym, dim=-1), dim=-1) \
            / np.sqrt(L)
    else:
        fd = ce_batch.dct_ortho(h_sym, inverse=True)
    # uniform-stride linear interpolation to every RE (np.interp clamps
    # past the last sample)
    idx, nxt, frac = ce_batch.interp_tables(L, rd, torch.float64, fd.device)
    fi, fn = fd[:, idx], fd[:, nxt]
    full = fi + frac[None, :] * (fn - fi)
    sl = full[:, ek * rd: ek * rd + rd * re_num]
    h_est = sl.reshape(sym_num, nr, nt, rd * re_num).movedim(-1, 1).to(
        torch.complex64)
    rs_map = np.asarray(RS_info["RSSymMap"], np.int64)
    h_result = _time_interp(h_est, rs_map)
    cov = _cov_estimate(H_LS, h_est, rd, RS_info["NumCDMGroupsWithoutData"],
                        rs_map)
    return h_result, cov


def _time_interp(arr: torch.Tensor, rs_map) -> torch.Tensor:
    """(sym, ...) -> (14, ...) linear-fit interpolation over symbols."""
    return ce_batch._time_interp(arr[None], np.asarray(rs_map))[0] \
        .contiguous()


def _cov_estimate(H_LS, h_est, rd, n_cdm, rs_map) -> torch.Tensor:
    """Per-16-PRB noise covariance (14, PRB, Nr, Nr)."""
    return ce_batch._cov_estimate(H_LS[None], h_est[None], rd, int(n_cdm),
                                  np.asarray(rs_map))[0].contiguous()


class NrChannelEstimation:
    """Reference-compatible per-slot channel estimator on H_LS's device.

    H_LS: (sym_num, RE_num, Nr, Nt) LS estimates on RS REs, a tensor (or
    numpy, taken to the card). channel_est() -> (H (14, RE*rd, Nr, Nt),
    cov (14, PRB, Nr, Nr)); TO_est (sym,) and FO_est stay tensors.
    """

    def __init__(self, H_LS, RS_info: dict, CE_config: dict):
        self.H_LS = on_device(H_LS).to(torch.complex64).clone()
        self.RS_info = RS_info
        CE_config.setdefault("freq_intp_method", "linear")
        CE_config.setdefault("timing_intp_method", "linear")
        self.CE_config = CE_config
        self.freq_offset = None
        self.FO_status, self.FO_est = False, 0
        sym_num = self.H_LS.shape[0]
        assert sym_num == len(RS_info["RSSymMap"])
        # peak (nr, nt) pair by mean power
        nr, nt = self.H_LS.shape[2:]
        power = (self.H_LS.abs() ** 2).mean(dim=(0, 1)).reshape(-1)
        self._peak = power.argmax()
        self.symbols_timing_offset_list = symbol_timing_offsets(
            RS_info["scs"])[0]

    @property
    def peak_H_LS(self) -> torch.Tensor:
        """(sym, RE) H_LS of the peak pair, read from H_LS each time: as
        the NumPy class's view, it shows the in-place TO compensation."""
        return self.H_LS.reshape(self.H_LS.shape[:2] + (-1,)).index_select(
            2, self._peak.reshape(1))[:, :, 0]

    # -- estimation steps ---------------------------------------------------
    def timing_offset_est(self):
        rd = self.RS_info["RE_distance"]
        scs = self.RS_info["scs"]
        h = self.peak_H_LS
        conv = h[:, 1:] * h[:, :-1].conj()
        self.TO_est = torch.atan2(conv.imag, conv.real).mean(dim=1) \
            / (2 * np.pi * rd * scs * 1000)
        return self.TO_est

    def comp_H_LS_timing_offset(self):
        rd = self.RS_info["RE_distance"]
        scs = self.RS_info["scs"]
        k = torch.arange(self.H_LS.shape[1], dtype=torch.float64,
                         device=self.H_LS.device) * (2 * np.pi * rd
                                                     * scs * 1000)
        ramp = _cis(-self.TO_est.mean().to(torch.float64) * k)
        self.H_LS *= ramp.to(torch.complex64)[None, :, None, None]

    def freq_offset_est(self):
        """Carrier-frequency-offset estimate from the peak tap's phase
        rotation across DMRS symbols -> (status, FO_est Hz tensor).

        Valid only where the maximum Doppler f_m is well below the CFO
        accuracy needed (fo_est_valid_for_doppler): the phase slope of the
        strongest tap cannot tell a CFO from the fading's own rotation."""
        rs_map = self.RS_info["RSSymMap"]
        if len(rs_map) == 1:
            self.FO_est = 0
            return False, 0
        t_off = self.symbols_timing_offset_list[rs_map]
        sel = self.peak_H_LS
        start = _NFFT // 2 - sel.shape[1] // 2
        buf = torch.nn.functional.pad(
            sel, (start, _NFFT - start - sel.shape[1]))
        td = torch.fft.ifft(buf, dim=-1)                   # (sym, NFFT)
        max_v = td.index_select(1, td[0].abs().argmax().reshape(1))[:, 0]
        conv = max_v[1:] * max_v[:-1].conj()
        fo_diff = torch.atan2(conv.imag, conv.real).to(torch.float64) \
            / (2 * np.pi)
        dt = torch.as_tensor(t_off[1:] - t_off[:-1], device=sel.device)
        self.FO_est = (fo_diff / dt).mean()
        return True, self.FO_est

    def _fo_comp(self, data, sym_offsets, re_distance):
        """Per-symbol frequency-offset compensation of a (n_sym, RE_num,
        ...) grid sampled every re_distance REs."""
        fo = torch.as_tensor(self._fo_value, device=data.device).to(
            torch.float32).reshape(1)
        return ce_batch._fo_comp(data[None], fo, np.asarray(sym_offsets),
                                 re_distance, self.RS_info["scs"])[0]

    def comp_H_LS_freq_offset(self, freq_offset):
        self._fo_value = freq_offset
        rs_map = self.RS_info["RSSymMap"]
        self.H_LS = self._fo_comp(
            self.H_LS, self.symbols_timing_offset_list[rs_map],
            self.RS_info["RE_distance"])

    def channel_est(self, freq_offset=None):
        self.freq_offset = freq_offset
        self.timing_offset_est()
        if self.CE_config["enable_TO_comp"]:
            self.comp_H_LS_timing_offset()
        if self.CE_config["enable_FO_est"]:
            fo_status, fo_est = self.freq_offset_est()
        else:
            fo_status, fo_est = False, 0
        self.FO_status, self.FO_est = fo_status, fo_est
        if self.CE_config["enable_FO_comp"]:
            if freq_offset:
                self.comp_H_LS_freq_offset(freq_offset)
            elif fo_status:
                self.comp_H_LS_freq_offset(fo_est)
        algo = self.CE_config["CE_algo"]
        base = algo.replace("_symmetric", "")
        if base not in ("DFT", "DCT"):
            raise ValueError(f"unsupported CE algo {algo}")
        h, cov = dft_dct_channel_estimate(
            self.H_LS, self.RS_info, self.CE_config, base,
            symmetric=algo.endswith("_symmetric"))
        self.H_result, self.cov_m = h, cov
        return h, cov

    def process_pdsch_data(self, pdsch_resource, pdsch_start_sym):
        """TO/FO compensation of the data REs (nsym, RE, Nr). With FO
        compensation on, the estimate is read on the host (the reference
        skips a zero offset). Numpy data goes to H_LS's device."""
        res = pdsch_resource if isinstance(pdsch_resource, torch.Tensor) \
            else torch.as_tensor(pdsch_resource, device=self.H_LS.device)
        res = res.to(torch.complex64)
        if self.CE_config["enable_TO_comp"]:
            scs = self.RS_info["scs"]
            k = torch.arange(res.shape[1], dtype=torch.float64,
                             device=res.device) * (2 * np.pi * scs * 1000)
            ramp = _cis(-self.TO_est.mean().to(torch.float64) * k)
            res = res * ramp.to(torch.complex64)[None, :, None]
        if self.CE_config["enable_FO_comp"]:
            fo = self.freq_offset if self.freq_offset else (
                self.FO_est if self.FO_status else None)
            if fo is not None and bool(fo != 0):
                self._fo_value = fo
                offs = self.symbols_timing_offset_list[
                    pdsch_start_sym: pdsch_start_sym + res.shape[0]]
                res = self._fo_comp(res, offs, 1)
        return res.to(torch.complex64)
