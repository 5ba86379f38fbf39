"""MIMO fading channel model: AWGN / TDL / Rayleigh / Rician + impairments.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/models/channel.py (NrChannelModel: CFO
rotation, integer/fractional TA split, per-tap Kronecker-correlated MIMO
fading, AWGN, per-symbol timing-error matrix Dm; sum-of-sinusoids
Rayleigh/Rician generators; the TR 38.901 TDL-A..E profiles from
data/tdl_profiles.npz). Randomness comes from an explicit
torch.Generator on the model's device. filter() also takes pre-drawn
fading taps and noise, so that a run can reproduce another
implementation's draws.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from portbench.reference.frozen import resolve_device

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data"


def gen_correlation_matrix(size: int, delta) -> np.ndarray:
    """38.104 Table G.2.3.1.1-1 style exponential correlation matrix."""
    if size not in (1, 2, 4, 8):
        raise ValueError(f"unsupported antenna count {size}")
    r = np.eye(size, dtype=np.complex64)
    if size == 1:
        return r
    if size == 2:
        r[0, 1] = delta
        r[1, 0] = np.conjugate(delta)
        return r
    step = 1 / ((size - 1) ** 2)
    seq = np.arange(1, size) ** 2
    for line in range(size - 1):
        r[line, line + 1:] = delta ** (step * seq[: size - line - 1])
    for col in range(size - 1):
        r[col + 1:, col] = np.conjugate(r[col, col + 1:])
    return r


_DL_UNIFORM = {"low": (0, 0), "medium": (0.3, 0.9), "mediumA": (0.3, 0.3874),
               "high": (0.9, 0.9)}
_UL_UNIFORM = {"low": (0, 0), "medium": (0.9, 0.3), "high": (0.9, 0.9)}


def get_nr_mimo_rspat(nt: int, nr: int, polarization: str = "uniform",
                      direction: str = "DL",
                      correlation: str = "customized",
                      parameters=(0, 0)) -> np.ndarray:
    """MIMO correlation matrix (uniform ULA and customized alpha/beta)."""
    if correlation == "customized":
        alpha, beta = parameters
        rspat = np.kron(gen_correlation_matrix(nt, alpha),
                        gen_correlation_matrix(nr, beta))
        a = 0.00012
        return ((rspat + a * np.eye(nt * nr, dtype=np.complex64))
                / (1 + a)).astype(np.complex64)
    if polarization != "uniform":
        raise ValueError("cross-polar: use customized alpha/beta")
    if direction == "DL":
        alpha, beta = _DL_UNIFORM[correlation]
        r_tx = gen_correlation_matrix(nt, alpha)
        r_rx = gen_correlation_matrix(nr, beta)
        loads = {(4, 2, "high"): 0.00010, (4, 4, "high"): 0.00012,
                 (2, 4, "medium"): 0.00010, (4, 4, "medium"): 0.00012}
        a = loads.get((nt, nr, correlation), 0)
    else:
        alpha, beta = _UL_UNIFORM[correlation]
        r_tx = gen_correlation_matrix(nt, beta)
        r_rx = gen_correlation_matrix(nr, alpha)
        a = 0
    rspat = np.kron(r_tx, r_rx)
    return ((rspat + a * np.eye(nt * nr, dtype=np.complex64))
            / (1 + a)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _tdl_table(model: str) -> np.ndarray:
    """(5, taps) TR 38.901 Tables 7.7.2-1..5: normalized delay, power dB,
    Rician flag, K dB, normalized Doppler."""
    with np.load(_DATA / "tdl_profiles.npz") as z:
        return z[model.replace("-", "_")].copy()


def get_tdl_model_config(model: str, ds_desired_ns: float,
                         fm_hz: float) -> list:
    """Tap list [[delay_ns, power_dB, dist, K_dB, fDo_Hz], ...]."""
    t = _tdl_table(model)
    return [[float(t[0, i]) * ds_desired_ns, float(t[1, i]),
             "Rician" if t[2, i] else "Rayleigh", float(t[3, i]),
             float(t[4, i]) * fm_hz] for i in range(t.shape[1])]


def gen_channel_model_config(model_format="AWGN",
                             Rspat_config=("customized", "uniform", "DL",
                                           (0, 0)),
                             Nt=1, Nr=1, Timeoff_ns=0, rho=0, fm_inHz=0,
                             multi_paths=((0, 0, "Rayleigh", 0, 0),),
                             fDo_in_Hz=0, Rspat_in=None, DSdesired=100):
    """Mirrors nr_channel_model.gen_channel_model_config: AWGN, the TDL-A
    .. TDL-E profiles scaled to the delay spread DSdesired (ns), or the
    customized multi_paths."""
    cfg = dict(num_of_sinusoids=30, Nt=Nt, Nr=Nr, Timeoff_ns=Timeoff_ns,
               rho=rho, fm_inHz=fm_inHz, fDo_in_Hz=fDo_in_Hz)
    if model_format == "AWGN":
        cfg["multi_paths"] = []
    elif model_format in ("TDL-A", "TDL-B", "TDL-C", "TDL-D", "TDL-E"):
        cfg["multi_paths"] = get_tdl_model_config(model_format, DSdesired,
                                                  fm_inHz)
    elif model_format == "customized":
        cfg["multi_paths"] = [list(p) for p in multi_paths]
    else:
        raise ValueError(model_format)
    if Rspat_config:
        corr, pol, direction, params = Rspat_config
        rspat = get_nr_mimo_rspat(Nt, Nr, pol, direction, corr, params)
    elif Rspat_in is not None and np.asarray(Rspat_in).size:
        rspat = np.asarray(Rspat_in, np.complex64)
    else:
        rspat = np.eye(Nt * Nr, dtype=np.complex64)
    cfg["Rspat"] = np.eye(Nt * Nr, dtype=np.complex64) \
        if model_format == "AWGN" else rspat
    return cfg


def rayleigh_filters(gen: torch.Generator, n: int, fmax: float, fs: float,
                     n_sin: int, shape=()) -> torch.Tensor:
    """(..., n) Rayleigh fading series, model I random-walk sinusoids."""
    dev = gen.device

    def uni():
        return (torch.rand(shape + (n_sin, 1), generator=gen, device=dev)
                * 2 - 1) * np.pi

    phase1, phase2, seta = uni(), uni(), uni()
    m = torch.arange(n, device=dev, dtype=torch.float32)[None, :]
    w = 2 * np.pi * fmax / fs
    amp = np.sqrt(2 / n_sin)
    ci = amp * torch.cos(w * m * torch.cos(seta) + phase1).sum(dim=-2)
    cq = amp * torch.cos(w * m * torch.sin(seta) + phase2).sum(dim=-2)
    return torch.complex(ci, cq)


def rician_filters(gen: torch.Generator, n: int, k_db: float, fdo: float,
                   fmax: float, fs: float, n_sin: int,
                   shape=()) -> torch.Tensor:
    cm = rayleigh_filters(gen, n, fmax, fs, n_sin, shape)
    dev = gen.device
    phase0 = (torch.rand(shape + (1,), generator=gen, device=dev) * 2 - 1) \
        * np.pi
    ang = 2 * np.pi * fdo / fs * torch.arange(n, device=dev) + phase0
    los = torch.polar(torch.ones_like(ang), ang)
    kv = 10 ** (k_db / 10)
    return cm / np.sqrt(kv + 1) + np.sqrt(kv / (kv + 1)) * los


def gen_mimo_channel(gen: torch.Generator, nt: int, nr: int,
                     rspat: np.ndarray, n: int, fs: float, channel: str,
                     k_db: float, fdo: float, fmax: float,
                     n_sin: int) -> torch.Tensor:
    """(n, Nr, Nt) correlated per-sample MIMO channel."""
    if channel == "Rayleigh":
        vec = rayleigh_filters(gen, n, fmax, fs, n_sin, shape=(nt * nr,))
    else:
        vec = rician_filters(gen, n, k_db, fdo, fmax, fs, n_sin,
                             shape=(nt * nr,))
    L = np.linalg.cholesky(np.asarray(rspat)) if rspat.shape[0] > 1 \
        else rspat
    mixed = torch.as_tensor(np.asarray(L, np.complex64),
                            device=vec.device) @ vec          # (Nt*Nr, n)
    # vec_H.reshape((Nr, Nt), order='F') == reshape (Nt, Nr), transpose
    return mixed.reshape(nt, nr, n).permute(2, 1, 0)


def _delay(x: torch.Tensor, d: int) -> torch.Tensor:
    """Shift along the last axis by d samples with zero fill."""
    if not d:
        return x
    x = torch.roll(x, d, dims=-1)
    if d > 0:
        x[..., :d] = 0
    else:
        x[..., d:] = 0
    return x


class NrChannelModel:
    """Channel orchestrator with the reference API; randomness from a
    torch.Generator seeded with `seed` on `device` (None -> cuda)."""

    def __init__(self, channel_model_config: dict, Pnoise_dB: float,
                 fi_inHz: float, fs_inHz: float, scs: int, seed: int = 0,
                 device=None):
        cfg = channel_model_config
        self.device = resolve_device(device)
        self.nt, self.nr = cfg["Nt"], cfg["Nr"]
        self.timeoff_ns = cfg["Timeoff_ns"]
        self.rho = cfg["rho"]
        self.fm = cfg["fm_inHz"]
        self.rspat = np.asarray(cfg["Rspat"])
        self.pnoise_db = Pnoise_dB
        self.multi_paths = cfg["multi_paths"]
        self.fi, self.fs, self.scs = fi_inHz, fs_inHz, scs
        self.n_sin = cfg["num_of_sinusoids"]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.n_integer_ta = int(np.round(self.timeoff_ns * 1e-9 * fs_inHz))
        self.ta_frac = self.timeoff_ns * 1e-9 - self.n_integer_ta / fs_inHz
        if scs == 15:
            cps, nfft, fs0 = [160] + [144] * 6 + [160] + [144] * 6, 2048, \
                30.72e6
        else:
            cps, nfft, fs0 = [352] + [288] * 13, 4096, 122.88e6
        self.symbols_offset_s = (np.cumsum(cps)
                                 + nfft * np.arange(14)) / fs0

    def gen_Dm(self, numofslots: int) -> np.ndarray:
        """Per-symbol fractional timing error matrix (slots, 14)."""
        dm = np.zeros((numofslots, 14))
        terr = 0.0
        slot_s = 1e-3 if self.scs == 15 else 0.5e-3
        for slot in range(numofslots):
            dm[slot] = self.symbols_offset_s * self.rho + terr - self.ta_frac
            terr += slot_s * self.rho
        return dm

    def filter(self, tx: torch.Tensor, taps=None, noise=None
               ) -> torch.Tensor:
        """(Nt, N) tx samples -> (Nr, N) rx samples through the channel.

        taps: optional per-path (N, Nr, Nt) complex fading taps and noise
        an optional (Nr, N) complex unit-variance-per-component AWGN draw
        (scaled here), used instead of this model's own draws.
        """
        dev = self.device
        tx = tx.to(dev, torch.complex64)
        n = tx.shape[1]
        ferr = self.fi * self.rho
        if ferr:
            ang = 2 * np.pi * ferr * torch.arange(n, device=dev) / self.fs
            tx = tx * torch.polar(torch.ones_like(ang), ang)
        tx = _delay(tx, self.n_integer_ta)
        if self.multi_paths:
            if taps is not None and len(taps) != len(self.multi_paths):
                raise ValueError(f"{len(taps)} tap series for "
                                 f"{len(self.multi_paths)} paths")
            acc = torch.zeros((self.nr, n), dtype=torch.complex64,
                              device=dev)
            for i, path in enumerate(self.multi_paths):
                if taps is None:
                    h = gen_mimo_channel(self.gen, self.nt, self.nr,
                                         self.rspat, n, self.fs, path[2],
                                         path[3], path[4], self.fm,
                                         self.n_sin)
                else:
                    h = taps[i].to(dev, torch.complex64)
                tap = torch.einsum("nrt,tn->rn", h, tx) * 10 ** (path[1] / 20)
                acc = acc + _delay(tap, int(np.round(path[0] * 1e-9
                                                     * self.fs)))
        else:
            acc = tx.expand(self.nr, n) if self.nt == self.nr \
                else tx[: self.nr]
        if self.pnoise_db != 255:
            sigma = 10 ** (self.pnoise_db / 20) / np.sqrt(2)
            if noise is None:
                noise = torch.complex(
                    torch.randn(acc.shape, generator=self.gen, device=dev),
                    torch.randn(acc.shape, generator=self.gen, device=dev))
            acc = acc + sigma * noise.to(dev, torch.complex64)
        return acc
