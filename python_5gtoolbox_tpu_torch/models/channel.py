"""MIMO fading channel model: AWGN / TDL / Rayleigh / Rician + impairments.

Port of python_5gtoolbox_tpu/models/channel.py (NrChannelModel: CFO
rotation, integer/fractional TA split, per-tap Kronecker-correlated MIMO
fading, AWGN, per-symbol timing-error matrix Dm; sum-of-sinusoids
Rayleigh/Rician generators; the TR 38.901 TDL-A..E profiles from
data/tdl_profiles.npz). Randomness comes from an explicit
torch.Generator on the model's device. filter() also takes pre-drawn
fading taps and noise, so that a run can reproduce another
implementation's draws.

On a CUDA tensor with the model's own draws, filter() fades every path
in one launch of the hand-written kernel csrc/fading_channel.cu
(fading_channel), which makes the sum-of-sinusoids taps on the chip from
the same uniforms, drawn in the same order; the plain per-path loop
(filter_plain) is the CPU path, the path of pre-drawn taps and of shapes
the kernel does not take, and the kernel's counterpart on the card.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import kernels, resolve_device
from python_5gtoolbox_tpu_torch.utils import profiling

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data"
# what csrc/fading_channel.cu takes: links (Nt Nr) and sinusoids a link
FADING_KERNEL_MAX_LINKS = 16
FADING_KERNEL_MAX_SINUSOIDS = 64
# a path's row of the kernel's constants, after the factor L
_PATH_ROW = np.dtype([("gain", "<f4"), ("delay", "<i4"), ("rician", "<i4"),
                      ("nlos", "<f4"), ("los", "<f4"), ("fdo", "<f4")])


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
    mixed = torch.as_tensor(_cholesky(rspat),
                            device=vec.device) @ vec          # (Nt*Nr, n)
    # vec_H.reshape((Nr, Nt), order='F') == reshape (Nt, Nr), transpose
    return mixed.reshape(nt, nr, n).permute(2, 1, 0)


def _cholesky(rspat: np.ndarray) -> np.ndarray:
    """The complex64 factor that mixes the links of every path."""
    L = np.linalg.cholesky(np.asarray(rspat)) if rspat.shape[0] > 1 \
        else rspat
    return np.asarray(L, np.complex64)


def _path_delay(path, fs: float) -> int:
    return int(np.round(path[0] * 1e-9 * fs))


def fading_on_kernel(tx: torch.Tensor, links: int, n_sin: int) -> bool:
    """Whether filter() fades with csrc/fading_channel.cu: a CUDA tensor,
    at most 16 links (Nt Nr) and 64 sinusoids. Anything else, and pre-drawn
    taps, take the plain per-path loop."""
    return (tx.is_cuda and links <= FADING_KERNEL_MAX_LINKS
            and n_sin <= FADING_KERNEL_MAX_SINUSOIDS)


def fading_draws(gen: torch.Generator, paths, links: int, n_sin: int):
    """The uniforms of every path in the plain path's order and shapes
    (rayleigh_filters' phase1, phase2, seta (links, n_sin, 1), then
    rician_filters' phase0 (links, 1) on a Rician path), drawn into one
    (paths, 3, links, n_sin, 1) and one (paths, links, 1) float32 tensor,
    so that the generator ends where the plain path leaves it. A Rayleigh
    path's row of the second is left unset."""
    dev = gen.device
    draws = torch.empty((len(paths), 3, links, n_sin, 1), device=dev)
    draws0 = torch.empty((len(paths), links, 1), device=dev)
    for p, path in enumerate(paths):
        for j in range(3):
            torch.rand((links, n_sin, 1), generator=gen, out=draws[p, j])
        if path[2] != "Rayleigh":
            torch.rand((links, 1), generator=gen, out=draws0[p])
    return draws, draws0


def fading_constants(rspat: np.ndarray, paths, fs: float,
                     device) -> torch.Tensor:
    """csrc/fading_channel.cu's constants as bytes on device: the (links,
    links) complex64 factor L, then a row a path of gain 10^(dB / 20),
    delay in samples, Rician flag, fl(1 / fl(sqrt(K + 1))) (the plain
    path divides by a scalar as a product with its reciprocal), sqrt(K /
    (K + 1)) and 2 pi fDo / fs. A configuration's constants are uploaded
    once a device (a pageable copy synchronises) and kept."""
    kv = np.array([10 ** (p[3] / 10) for p in paths])
    rows = np.zeros(len(paths), _PATH_ROW)
    rows["gain"] = [10 ** (p[1] / 20) for p in paths]
    rows["delay"] = [_path_delay(p, fs) for p in paths]
    rows["rician"] = [p[2] != "Rayleigh" for p in paths]
    rows["nlos"] = np.float32(1) / np.sqrt(kv + 1).astype(np.float32)
    rows["los"] = np.sqrt(kv / (kv + 1))
    rows["fdo"] = [2 * np.pi * p[4] / fs for p in paths]
    return _on_device(_cholesky(rspat).tobytes() + rows.tobytes(),
                      str(torch.device(device)))


@functools.lru_cache(maxsize=32)
def _on_device(blob: bytes, device: str) -> torch.Tensor:
    return torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)


def fading_channel(tx: torch.Tensor, draws: torch.Tensor,
                   draws0: torch.Tensor, consts: torch.Tensor, nr: int,
                   w: float, amp: float) -> torch.Tensor:
    """The faded sum over paths of NrChannelModel.filter_plain, one launch
    of the hand-written kernel csrc/fading_channel.cu: tx (Nt, N)
    complex64, the uniforms of fading_draws, the constants of
    fading_constants, all contiguous on one CUDA device; w = 2 pi fm / fs,
    amp = sqrt(2 / n_sin) -> (Nr, N) complex64. Nothing of size (links,
    sinusoids, samples) and no per-path tap reaches device memory.
    Replaces no TPU kernel (the JAX package's generator is plain jnp)."""
    nt, n = tx.shape
    n_paths, three, links, n_sin, one = draws.shape
    dev = tx.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (draws, draws0, consts)):
        raise ValueError("fading_channel: tx, draws, draws0 and consts must "
                         "be on one CUDA device")
    if (tx.dtype, draws.dtype, draws0.dtype, consts.dtype) != (
            torch.complex64, torch.float32, torch.float32, torch.uint8):
        raise ValueError("fading_channel: tx must be complex64, the draws "
                         "float32 and consts uint8")
    if (three, one) != (3, 1) or links != nt * nr \
            or tuple(draws0.shape) != (n_paths, links, 1) \
            or consts.numel() != 8 * links * links \
            + _PATH_ROW.itemsize * n_paths:
        raise ValueError(f"fading_channel: draws {tuple(draws.shape)}, "
                         f"draws0 {tuple(draws0.shape)} and {consts.numel()} "
                         f"constant bytes do not fit tx {tuple(tx.shape)} "
                         f"and Nr {nr}")
    if not (tx.is_contiguous() and draws.is_contiguous()
            and draws0.is_contiguous() and consts.is_contiguous()):
        raise ValueError("fading_channel: tx, draws, draws0 and consts must "
                         "be contiguous")
    if not (1 <= links <= FADING_KERNEL_MAX_LINKS and n_paths >= 1
            and 1 <= n_sin <= FADING_KERNEL_MAX_SINUSOIDS):
        raise ValueError(f"fading_channel: takes 1..{FADING_KERNEL_MAX_LINKS}"
                         f" links, 1..{FADING_KERNEL_MAX_SINUSOIDS} "
                         f"sinusoids and a path or more, got {links}, "
                         f"{n_sin}, {n_paths}")
    out = torch.empty((nr, n), dtype=torch.complex64, device=dev)
    if n == 0:
        return out
    fn = kernels.library("fading_channel").fading_channel
    rc = fn(tx.data_ptr(), draws.data_ptr(), draws0.data_ptr(),
            consts.data_ptr(), out.data_ptr(), n, nt, nr, n_paths, n_sin, w,
            amp, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("fading_channel", rc)
    kernels.LAUNCHES["fading_channel"] += 1
    return out


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
        (scaled here), used instead of this model's own draws. With its own
        taps the paths are one launch of csrc/fading_channel.cu where
        fading_on_kernel says so, else the plain per-path loop. On a CUDA
        tensor the counters fading_kernel_paths / fading_plain_paths count
        the paths of each route; a CPU tensor, which has no kernel to take,
        counts nothing.
        """
        return self._filter(tx, taps, noise, True)

    def filter_plain(self, tx: torch.Tensor, taps=None, noise=None
                     ) -> torch.Tensor:
        """filter through the plain per-path loop on any device: the same
        draws, the kernel's counterpart on the card."""
        return self._filter(tx, taps, noise, False)

    def _filter(self, tx, taps, noise, on_kernel: bool) -> torch.Tensor:
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
            if on_kernel and taps is None and fading_on_kernel(
                    tx, self.nt * self.nr, self.n_sin):
                profiling.count("fading_kernel_paths", len(self.multi_paths))
                acc = fading_channel(
                    tx.contiguous(),
                    *fading_draws(self.gen, self.multi_paths,
                                  self.nt * self.nr, self.n_sin),
                    fading_constants(self.rspat, self.multi_paths, self.fs,
                                     dev),
                    self.nr, 2 * np.pi * self.fm / self.fs,
                    np.sqrt(2 / self.n_sin))
            else:
                if tx.is_cuda:
                    profiling.count("fading_plain_paths",
                                    len(self.multi_paths))
                acc = self._paths_plain(tx, taps)
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

    def _paths_plain(self, tx: torch.Tensor, taps) -> torch.Tensor:
        """The faded sum over paths, path by path: each path's (N, Nr, Nt)
        taps (drawn here, or taps[i]) applied to tx, delayed and added."""
        dev = self.device
        n = tx.shape[1]
        acc = torch.zeros((self.nr, n), dtype=torch.complex64, device=dev)
        for i, path in enumerate(self.multi_paths):
            if taps is None:
                h = gen_mimo_channel(self.gen, self.nt, self.nr, self.rspat,
                                     n, self.fs, path[2], path[3], path[4],
                                     self.fm, self.n_sin)
            else:
                h = taps[i].to(dev, torch.complex64)
            tap = torch.einsum("nrt,tn->rn", h, tx) * 10 ** (path[1] / 20)
            acc = acc + _delay(tap, _path_delay(path, self.fs))
        return acc
