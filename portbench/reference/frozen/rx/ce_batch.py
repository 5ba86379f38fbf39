"""Slot-batched channel estimation (DFT/DCT CE, TO/FO compensation).

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/rx/ce_jax.py (channel_est_batch,
comp_data_batch; reference: py5gphy/channel_estimate/
nr_channel_estimation.py and dft_dct_CE.py:10) with a leading slot axis.
CE_config flags and shapes are plan-time; only the H_LS values are
tensors. The DCT models use the orthonormal DCT-II and its inverse as an
L x L matrix made on the host in float64 (PyTorch has no DCT), applied
to the real and imaginary planes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.frozen.utils.numerology import symbol_timing_offsets

_NFFT = 4096  # reference's fixed CE working FFT size


def _t(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


def _cis(ang: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(ang), ang)


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(L: int) -> np.ndarray:
    """(L, L) orthonormal DCT-II: X = D @ x equals scipy.fft.dct(x,
    norm="ortho"); its inverse (idct, norm="ortho") is D.T."""
    k = np.arange(L)[:, None]
    n = np.arange(L)[None, :]
    d = np.cos(np.pi * k * (2 * n + 1) / (2 * L)) * np.sqrt(2.0 / L)
    d[0] /= np.sqrt(2.0)
    return d


@functools.lru_cache(maxsize=32)
def dct_matrix(L: int, dtype: torch.dtype, device: torch.device):
    """The (L, L) orthonormal DCT-II matrix on the device, once per size,
    built in float64 and cast to dtype."""
    return torch.as_tensor(_dct_matrix_np(L), device=device).to(dtype)


def dct_ortho(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Orthonormal DCT-II (or its inverse) along the last axis of a
    complex tensor, on the real and imaginary planes."""
    d = dct_matrix(x.shape[-1], x.real.dtype, x.device)
    m = d if inverse else d.T
    return torch.complex(x.real @ m, x.imag @ m)


@functools.lru_cache(maxsize=64)
def lsq_weights(x: tuple, x_new: tuple, dtype: torch.dtype,
                device: torch.device):
    """(w (n,), mean of x, x_new (m,)) of a deg-1 least-squares fit over
    the static abscissae x, evaluated at x_new, on the device."""
    xa = np.asarray(x, np.float64)
    xm = xa.mean()
    w = (xa - xm) / ((xa - xm) ** 2).sum()
    return (torch.as_tensor(w, device=device).to(dtype), float(xm),
            torch.as_tensor(np.asarray(x_new, np.float64),
                            device=device).to(dtype))


def _lsq_extend(x: np.ndarray, y: torch.Tensor, x_new: np.ndarray):
    """Batched deg-1 least squares along the last axis: y (..., n) over
    static x (n,), evaluated at static x_new (m,) -> (..., m)."""
    w, xm, xn = lsq_weights(tuple(np.asarray(x).tolist()),
                            tuple(np.asarray(x_new).tolist()),
                            torch.float32, y.device)
    slope = torch.einsum("...n,n->...", y, w.to(y.dtype))
    intercept = y.mean(dim=-1) - slope * xm
    return intercept[..., None] + slope[..., None] * xn


@functools.lru_cache(maxsize=32)
def interp_tables(L: int, rd: int, dtype: torch.dtype,
                  device: torch.device):
    """(idx, next, frac) of the uniform-stride linear interpolation of L
    samples to L * rd points (np.interp clamps past the last sample)."""
    xnew = np.arange(L * rd)
    idx = np.minimum(xnew // rd, L - 1)
    nxt = np.minimum(idx + 1, L - 1)
    frac = np.where(idx == L - 1, 0.0, (xnew % rd) / rd)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(nxt, device=device),
            torch.as_tensor(frac, device=device).to(dtype))


def _zero_stuff(x: torch.Tensor, rd: int, start: int, total: int):
    """(..., n) -> (..., total) with x at [start : start+n*rd : rd]."""
    out = x.new_zeros(x.shape[:-1] + (total,))
    out[..., start: start + x.shape[-1] * rd: rd] = x
    return out


def _fo_comp(data: torch.Tensor, fo: torch.Tensor, sym_offsets: np.ndarray,
             rd: int, scs: int) -> torch.Tensor:
    """Frequency-offset compensation of (S, n_sym, RE, ...) grids sampled
    every `rd` REs; fo (S,) Hz."""
    s, n_sym, re_num = data.shape[:3]
    fs = _NFFT * scs * 1000
    start = (_NFFT - rd * re_num) // 2
    cols = data.reshape(s, n_sym, re_num, -1).movedim(2, 3)
    buf = _zero_stuff(cols.to(torch.complex64), rd, start, _NFFT)
    t = (np.asarray(sym_offsets, np.float64)[:, None]
         + np.arange(_NFFT) / fs)
    phase = (-2.0 * np.pi) * _t(t.astype(np.float32), data)
    ramp = _cis(fo[:, None, None, None] * phase[None, :, None, :])
    td = torch.fft.ifft(torch.fft.ifftshift(buf, dim=-1), dim=-1) * ramp
    fd = torch.fft.fftshift(torch.fft.fft(td, dim=-1), dim=-1)
    res = fd[..., start: start + rd * re_num: rd]
    return res.movedim(3, 2).reshape(data.shape).to(data.dtype)


def channel_est_batch(h_ls: torch.Tensor, rs_info: dict, ce_config: dict):
    """H_LS (S, n_sym, RE, Nr, Nt) -> dict with H (S, 14, RE*rd, Nr, Nt),
    cov (S, 14, PRB, Nr, Nr), to_avg (S,) [s], fo (S,) [Hz] and
    fo_applied (plan-time bool)."""
    h_ls = h_ls.to(torch.complex64)
    s, n_sym, re_num, nr, nt = h_ls.shape
    rd = int(rs_info["RE_distance"])
    scs = int(rs_info["scs"])
    rs_map = np.asarray(rs_info["RSSymMap"], np.int64)
    sym_offs = np.asarray(symbol_timing_offsets(scs)[0], np.float64)

    # peak (nr, nt) pair by mean power
    power = (h_ls.abs() ** 2).mean(dim=(1, 2)).reshape(s, nr * nt)
    sel = power.argmax(dim=-1)
    flat = h_ls.reshape(s, n_sym, re_num, nr * nt)
    peak = torch.take_along_dim(flat, sel[:, None, None, None], dim=-1
                                )[..., 0]                    # (S, sym, RE)

    # timing offset estimate (pre-compensation peak)
    conv = peak[:, :, 1:] * peak[:, :, :-1].conj()
    phase = torch.atan2(conv.imag, conv.real) / (2 * np.pi * rd * scs * 1000)
    to_avg = phase.mean(dim=(1, 2))                          # (S,)

    if ce_config["enable_TO_comp"]:
        k = np.arange(re_num, dtype=np.float64) * (2 * np.pi * rd
                                                   * scs * 1000)
        ramp = _cis(-to_avg[:, None] * _t(k.astype(np.float32), h_ls))
        h_ls = h_ls * ramp[:, None, :, None, None]

    fo = torch.zeros(s, dtype=torch.float32, device=h_ls.device)
    fo_applied = False
    if ce_config["enable_FO_est"] and len(rs_map) > 1:
        start = _NFFT // 2 - re_num // 2
        buf = torch.nn.functional.pad(peak, (start, _NFFT - start - re_num))
        td = torch.fft.ifft(buf, dim=-1)                     # (S, sym, NFFT)
        loc = td[:, 0, :].abs().argmax(dim=-1)
        max_v = torch.take_along_dim(td, loc[:, None, None], dim=-1)[..., 0]
        dv = max_v[:, 1:] * max_v[:, :-1].conj()
        fo_diff = torch.atan2(dv.imag, dv.real) / (2 * np.pi)
        t_off = sym_offs[rs_map]
        dt = _t((t_off[1:] - t_off[:-1]).astype(np.float32), h_ls)
        fo = (fo_diff / dt).mean(dim=-1)
        if ce_config["enable_FO_comp"]:
            fo_applied = True
            h_ls = _fo_comp(h_ls, fo, sym_offs[rs_map], rd, scs)

    h_result, cov = _dft_dct_batch(h_ls, rs_info, ce_config)
    return dict(H=h_result, cov=cov, to_avg=to_avg, fo=fo,
                fo_applied=fo_applied)


def comp_data_batch(res: torch.Tensor, start_sym: int, scs: int,
                    to_avg: torch.Tensor, fo, ce_config: dict):
    """TO/FO compensation of data REs (S, n_sym, RE, Nr)."""
    if ce_config["enable_TO_comp"]:
        k = np.arange(res.shape[2], dtype=np.float64) * (2 * np.pi * scs
                                                        * 1000)
        ramp = _cis(-to_avg[:, None] * _t(k.astype(np.float32), res))
        res = res * ramp[:, None, :, None]
    if ce_config["enable_FO_comp"] and fo is not None:
        offs = np.asarray(symbol_timing_offsets(scs)[0], np.float64)[
            start_sym: start_sym + res.shape[1]]
        res = _fo_comp(res, fo, offs, 1, scs)
    return res.to(torch.complex64)


def _time_interp(arr: torch.Tensor, rs_map: np.ndarray) -> torch.Tensor:
    """(S, n_sym, ...) -> (S, 14, ...) linear-fit interpolation."""
    s, n_sym = arr.shape[0], arr.shape[1]
    if n_sym == 1:
        return arr.expand((s, 14) + tuple(arr.shape[2:]))
    w, xm, t = lsq_weights(tuple(np.asarray(rs_map, np.float64).tolist()),
                           tuple(range(14)), torch.float32, arr.device)
    flat = arr.reshape(s, n_sym, -1)
    slope = torch.einsum("snk,n->sk", flat, w.to(arr.dtype))
    intercept = flat.mean(dim=1) - slope * xm
    out = intercept[:, None, :] + slope[:, None, :] * t[:, None]
    return out.reshape((s, 14) + tuple(arr.shape[2:]))


def _dft_dct_batch(h_ls: torch.Tensor, rs_info: dict, ce_config: dict):
    """Batched dft_dct_channel_estimate -> (H (S, 14, RE*rd, Nr, Nt), cov
    (S, 14, PRB, Nr, Nr))."""
    s, sym_num, re_num, nr, nt = h_ls.shape
    rd = int(rs_info["RE_distance"])
    scs = int(rs_info["scs"])
    algo = ce_config["CE_algo"]
    model = algo.replace("_symmetric", "")
    if model not in ("DFT", "DCT"):
        raise ValueError(f"unsupported CE algo {algo}")
    symmetric = algo.endswith("_symmetric")
    ek = int(ce_config["eRB"]) * 12 // rd
    right_ek = ek + (re_num + ek) % 2
    if re_num * rd // 12 <= 1:
        raise ValueError("one-PRB assignment unsupported")

    cols = h_ls.movedim(2, 4).reshape(-1, re_num)      # (S*sym*nr*nt, RE)
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
        h_sym = dct_ortho(ext)
    fs_tap = scs * 1000 * rd * L
    l_l = int(float(ce_config["L_symm_left_in_ns"]) * 1e-9 * fs_tap)
    if symmetric:
        l_l = min(L // 3 + L // 16, l_l)
        l_r = l_l
    else:
        l_r = int(float(ce_config["L_symm_right_in_ns"]) * 1e-9 * fs_tap)
    mid_mask = np.zeros(L, np.bool_)
    mid_mask[l_l: L - l_r] = True
    mid = _t(mid_mask, h_sym)
    pw = h_sym.abs() ** 2
    mid_p = torch.where(mid, pw, torch.zeros_like(pw)).sum(
        dim=-1, keepdim=True) / max(int(mid_mask.sum()), 1)
    zero = torch.zeros_like(h_sym)
    h_sym = torch.where(h_sym.abs() < torch.sqrt(mid_p / 2), zero, h_sym)
    h_sym = torch.where(mid, zero, h_sym)
    if model == "DFT":
        fd = torch.fft.fftshift(torch.fft.fft(h_sym, dim=-1), dim=-1) \
            / np.sqrt(L)
    else:
        fd = dct_ortho(h_sym, inverse=True)
    # uniform-stride linear interpolation to every RE (static indices)
    idx, nxt, frac = interp_tables(L, rd, torch.float32, fd.device)
    fi, fn = fd[:, idx], fd[:, nxt]
    full = fi + frac[None, :] * (fn - fi)
    sl = full[:, ek * rd: ek * rd + rd * re_num]
    h_est = sl.reshape(s, sym_num, nr, nt, rd * re_num).movedim(4, 2
                                                               ).to(
        torch.complex64)                      # (S, sym, RE*rd, nr, nt)
    rs_map = np.asarray(rs_info["RSSymMap"], np.int64)
    h_result = _time_interp(h_est, rs_map)
    cov = _cov_estimate(h_ls, h_est, rd,
                        int(rs_info["NumCDMGroupsWithoutData"]), rs_map)
    return h_result, cov


def _cov_estimate(h_ls, h_est, rd, n_cdm, rs_map):
    s, sym_num, re_num, nr, nt = h_ls.shape
    nhs = h_ls - h_est[:, :, ::rd, :, :]
    n_rb_cov = 16
    per = (12 // rd) * n_rb_cov
    n_blocks = re_num // per
    residual = re_num - n_blocks * per
    if residual and n_blocks >= 1:
        # merge the last full block into the residual for more averaging
        n_blocks -= 1
        residual += per
    total_prbs = re_num * rd // 12
    blocks, fill = [], []
    for b in range(n_blocks):
        seg = nhs[:, :, b * per:(b + 1) * per]
        blocks.append(torch.einsum("smkat,smkbt->smab", seg, seg.conj())
                      / per / nt)
        fill.append(n_rb_cov)
    if residual:
        seg = nhs[:, :, n_blocks * per:]
        blocks.append(torch.einsum("smkat,smkbt->smab", seg, seg.conj())
                      / residual / nt)
        fill.append(total_prbs - n_blocks * n_rb_cov)
    cov = torch.cat([c[:, :, None].expand(-1, -1, nrep, -1, -1)
                     for c, nrep in zip(blocks, fill)], dim=2)
    if n_cdm == 1:
        cov = cov * 2
    return _time_interp(cov.to(torch.complex64), rs_map)
