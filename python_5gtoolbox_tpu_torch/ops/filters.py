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

import dataclasses
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


# Launch geometry of csrc/banded_fir.cu (kept equal to its constants)
FIR_THREADS = 256
FIR_TILE = FIR_THREADS * 4 * 2     # branch positions per tile: 2 groups of
                                   # 4 consecutive outputs per thread
FIR_RING_OUTPUTS_PER_SM = 1 << 16  # above this many outputs per SM, blocks
                                   # of 2 tiles with a 2-window ring
FIR_MAX_TILES_PER_BLOCK = 4        # the most the tuner tries
FIR_MAX_STAGES = 2


def _round_up4(a: int) -> int:
    return -(-a // 4) * 4


@dataclasses.dataclass(frozen=True)
class FirPlan:
    """How csrc/banded_fir.cu runs one stage (fir_plan).

    A stage is written as one or two branches over a sample array w,
    each a 'same'-style sum over its own taps at a common delay d:

      same : y[v]        = sum_k H[k]  x[v + d - k]
      up2  : y[2v + e]   = sum_k H_e[k] x[v + d - k]         (e = 0, 1)
      down2: y[v]        = sum_k H_0[k] x_p0[v + d - k]
                          + sum_k H_1[k] x_p1[v + d - k],   x_p[m] = x[2m + p]

    with branch taps H_e[shift_e + k] = h[j0_e + step k] (k < kn_e; zeros
    elsewhere, kp per branch) and d a multiple of 4, so that a thread's
    four consecutive positions read aligned float4 groups. A tile covers
    `tile` positions v of one plane; its window holds w[v_lo + d - kp ..
    v_lo + tile + d) (down2: both phases, staged as the interleaved input
    x[2 (v_lo + d - kp) ..]). vec: the window is staged in 16-byte copies
    (rows of a multiple of 4 samples on a 16-byte aligned base), else
    sample by sample. The branches depend on (n, mode) only.
    """
    mode: str
    n: int
    t_in: int
    t_out: int
    planes: int
    kp: int
    d: int
    j0: tuple
    step: int
    kn: tuple
    shift: tuple
    phase: tuple            # down2: the input phase each branch reads
    scale: float
    positions: int          # branch positions per plane (v < positions)
    tiles: int              # tiles per plane
    tiles_per_block: int
    blocks: int
    stages: int             # window buffers in a block's ring
    vec: bool
    threads: int = FIR_THREADS
    tile: int = FIR_TILE

    @property
    def branches(self) -> int:
        return len(self.kn)

    @property
    def window(self) -> int:
        """Input samples staged per tile."""
        return (2 if self.mode == "down2" else 1) * (self.tile + self.kp)

    @property
    def smem_bytes(self) -> int:
        """Taps, the ring of windows, and for down2 the two phases."""
        floats = self.branches * self.kp + self.stages * self.window
        if self.mode == "down2":
            floats += 2 * (self.tile + self.kp)
        return 4 * floats

    @functools.cached_property
    def c_args(self) -> tuple:
        """The C entry's arguments after (x, h, y)."""
        return (self.planes, self.t_in, self.t_out, _MODES[self.mode],
                self.kp, self.d,
                self.phase[0] if self.phase else 0, self.tiles_per_block,
                self.stages, int(self.vec))

    def tile_window(self, k: int) -> tuple[int, int, int]:
        """(plane, first position, first input sample) of tile k of the
        flattened (plane, tile) order; the window holds self.window
        samples from the last on (zeros outside [0, t_in))."""
        plane, v_lo = divmod(k, self.tiles)
        v_lo *= self.tile
        lo = v_lo + self.d - self.kp
        return plane, v_lo, (2 * lo if self.mode == "down2" else lo)

    def pack(self, taps: np.ndarray) -> np.ndarray:
        """(branches, kp) float32 branch taps, scaled, zero-padded."""
        h = np.asarray(taps, np.float64) * self.scale
        out = np.zeros((self.branches, self.kp), np.float64)
        for e in range(self.branches):
            out[e, self.shift[e]:self.shift[e] + self.kn[e]] = \
                h[self.j0[e]::self.step][:self.kn[e]]
        return out.astype(np.float32)


@functools.lru_cache(maxsize=256)
def fir_plan(n: int, mode: str, t_in: int, planes: int, aligned: bool = True,
             tiles_per_block: int | None = None,
             stages: int | None = None) -> FirPlan:
    """The launch of csrc/banded_fir.cu for one stage of n taps over
    (planes, t_in) samples. aligned: the input's base address is a
    multiple of 16 bytes (the wrapper checks its tensor's).

    A block takes one tile into one window buffer, or, where the stage
    writes more than FIR_RING_OUTPUTS_PER_SM outputs per SM, two tiles
    through a ring of two (the second window arrives while the first is
    computed). That is the tuner's crossover (sim/time_filter_kernels.py
    --tune, PERF.md section 6): the ring was faster at the two stages of
    74.5K outputs per SM (up2 4x1228800, down2 8x2457600), one tile at
    those of 37.2K and fewer.
    tiles_per_block, stages: forced values (the tuner's); ValueError
    outside 1..FIR_MAX_TILES_PER_BLOCK and 1..FIR_MAX_STAGES."""
    b, t_out, scale = _stage(n, mode, t_in)
    if mode == "same":
        j0, step, kn, dd, phase = (0,), 1, (n,), (b,), ()
    elif mode == "up2":
        j0 = tuple((e + b) % 2 for e in range(2))
        step = 2
        kn = tuple((n - j + 1) // 2 for j in j0)
        dd = tuple((e + b - j) // 2 for e, j in zip(range(2), j0))
        phase = ()
    else:
        j0, step = (0, 1), 2
        kn = tuple((n - p + 1) // 2 for p in j0)
        dd = tuple((b - p) // 2 for p in j0)
        phase = tuple((b - p) % 2 for p in j0)
    d = _round_up4(max(max(dd), 0))
    shift = tuple(d - x for x in dd)
    kp = _round_up4(max(k + s for k, s in zip(kn, shift)))
    positions = t_out if mode == "down2" else t_in
    tiles = -(-positions // FIR_TILE)
    total = planes * tiles
    ring = planes * t_out > FIR_RING_OUTPUTS_PER_SM * kernels.H100_SMS
    tpb = (2 if ring else 1) if tiles_per_block is None else tiles_per_block
    stages = (2 if ring else 1) if stages is None else stages
    if not (1 <= tpb <= FIR_MAX_TILES_PER_BLOCK
            and 1 <= stages <= FIR_MAX_STAGES):
        raise ValueError(f"banded_fir: {tpb} tiles per block or {stages} "
                         f"stages out of range")
    return FirPlan(mode=mode, n=n, t_in=t_in, t_out=t_out, planes=planes,
                   kp=kp, d=d, j0=j0, step=step, kn=kn, shift=shift,
                   phase=phase, scale=scale, positions=positions,
                   tiles=tiles, tiles_per_block=tpb,
                   blocks=-(-total // tpb) if total else 0, stages=stages,
                   vec=bool(aligned and t_in % 4 == 0))


@functools.lru_cache(maxsize=64)
def _device_branch_taps(taps_key: bytes, mode: str,
                        device: torch.device) -> torch.Tensor:
    taps = np.frombuffer(taps_key, np.float64)
    # any plan of (n, mode) has the same branches
    return torch.as_tensor(fir_plan(len(taps), mode, 4, 1).pack(taps),
                           device=device)


def banded_fir(planes: torch.Tensor, taps: np.ndarray,
               mode: str) -> torch.Tensor:
    """One FIR stage on real planes: (P, T) float32 -> (P, T_out).

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_conv_kernel
    (reached through banded_conv). CUDA tensors go through the
    hand-written kernel csrc/banded_fir.cu, launched as fir_plan says;
    CPU tensors through banded_fir_plain.
    """
    if planes.device.type == "cpu":
        return banded_fir_plain(planes, taps, mode)
    if planes.device.type != "cuda":
        raise ValueError(f"banded_fir: unsupported device {planes.device}")
    if planes.dtype != torch.float32 or planes.dim() != 2 \
            or not planes.is_contiguous():
        raise ValueError("banded_fir: planes must be a contiguous 2-D "
                         "float32 tensor")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    p, t = planes.shape
    return _banded_fir_run(planes, taps, fir_plan(
        len(taps), mode, t, p, planes.data_ptr() % 16 == 0))


def _banded_fir_launch(planes: torch.Tensor, taps: np.ndarray,
                       plan: FirPlan) -> torch.Tensor:
    """banded_fir's launch as a forced plan says (one made for these
    planes, taps and alignment: the C entry refuses 16-byte staging
    otherwise)."""
    if (plan.n, plan.planes, plan.t_in) != (len(taps), *planes.shape):
        raise ValueError("banded_fir: the plan was made for other shapes")
    return _banded_fir_run(planes, taps, plan)


def _banded_fir_run(planes: torch.Tensor, taps: np.ndarray,
                    plan: FirPlan) -> torch.Tensor:
    y = torch.empty((plan.planes, plan.t_out), dtype=torch.float32,
                    device=planes.device)
    if plan.planes == 0 or plan.t_out == 0:
        return y
    h = _device_branch_taps(_taps_key(taps), plan.mode, planes.device)
    fn = kernels.library("banded_fir").banded_fir
    rc = fn(planes.data_ptr(), h.data_ptr(), y.data_ptr(), *plan.c_args,
            _stream(planes))
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
    """DDC: halfband /2 stages then FIR at carrier rate (rx_lowphy:100-164).
    The stages run on real planes: complex in, complex out, nothing
    converted in between."""
    lead, t = rx.shape[:-1], rx.shape[-1]
    xc = rx.to(torch.complex64).reshape(-1, t)
    y = torch.cat([xc.real, xc.imag]).contiguous()
    for _ in range(int(np.log2(_oversample(scs, bw, in_rate_hz)))):
        y = banded_conv_planes(y, halfband_coeff(), "down2")
    y = banded_conv_planes(y, fir_coeff(scs, bw), "same")
    m = xc.shape[0]
    return torch.complex(y[:m], y[m:]).reshape(lead + (y.shape[-1],))


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
                         hb_taps: np.ndarray,
                         plan: FusedPlan | None = None) -> torch.Tensor:
    """FIR `same` + halfband `up2` on real planes in one kernel:
    (P, T) float32 -> (P, 2T).

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_fused_kernel
    (entries fir_up2_fused_planes and fir_up2_fused; no pre-padding is
    needed here). CUDA tensors go through csrc/fir_up2_fused.cu, launched
    as fused_plan says (plan: a forced one, checked); CPU tensors through
    fir_up2_fused_plain.
    """
    if planes.device.type == "cpu":
        return fir_up2_fused_plain(planes, fir_taps, hb_taps)
    _check_planes("fir_up2_fused", planes, 2)
    p, t = planes.shape
    plan = checked_fused_plan(plan, p, t, len(fir_taps), len(hb_taps),
                              planes.data_ptr() % 16 == 0)
    z = torch.empty((p, 2 * t), dtype=torch.float32, device=planes.device)
    if p == 0 or t == 0:
        return z
    taps = _device_tap_blob(_taps_key(fir_taps), _taps_key(hb_taps),
                            plan.geometry.lead, planes.device)
    fn = kernels.library("fir_up2_fused").fir_up2_fused
    rc = fn(planes.data_ptr(), taps.data_ptr(), z.data_ptr(), *plan.c_args,
            _stream(planes))
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
                          fir_taps: np.ndarray, hb_taps: np.ndarray,
                          plan: FusedSymbolsPlan | None = None
                          ) -> torch.Tensor:
    """CP insertion + FIR + halfband `up2` in one kernel: (P, S, 14, nfft)
    float32 symbol planes -> (P, 2*S*slot_samples) float32.

    Replaces python_5gtoolbox_tpu/ops/pallas_filters.py:_fused_sym_kernel
    (entry fir_up2_fused_symbols). CUDA tensors go through
    csrc/fir_up2_fused_symbols.cu, launched as fused_symbols_plan says
    (plan: a forced one, checked); CPU tensors through
    fir_up2_fused_symbols_plain.
    """
    cps = tuple(np.asarray(cps).tolist())
    if sym_planes.device.type == "cpu":
        return fir_up2_fused_symbols_plain(sym_planes, cps, fir_taps,
                                           hb_taps)
    _check_planes("fir_up2_fused_symbols", sym_planes, 4)
    p, s, n_sym, nfft = sym_planes.shape
    if n_sym != 14 or len(cps) != 14 or max(cps) > nfft or min(cps) < 0:
        raise ValueError("fir_up2_fused_symbols: needs 14 symbols per slot "
                         "and 14 CP lengths within [0, nfft]")
    plan = checked_fused_symbols_plan(plan, p, s, nfft, len(fir_taps),
                                      len(hb_taps), cps,
                                      sym_planes.data_ptr() % 16 == 0)
    dev = sym_planes.device
    z = torch.empty((p, 2 * s * plan.slot_samples), dtype=torch.float32,
                    device=dev)
    if p == 0:
        return z
    taps = _device_tap_blob(_taps_key(fir_taps), _taps_key(hb_taps),
                            plan.geometry.lead, dev)
    fn = kernels.library("fir_up2_fused_symbols").fir_up2_fused_symbols
    rc = fn(sym_planes.data_ptr(), taps.data_ptr(), z.data_ptr(),
            plan.table_ptr, *plan.c_args, _stream(sym_planes))
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


# csrc/duc_common.cuh: threads per block and FIR outputs held per tile
DUC_THREADS = 256
DUC_TILE_Y = DUC_THREADS * 4
DUC_MAX_CLUSTER = 16              # with non-portable cluster sizes allowed
DUC_CLUSTER = 8                   # the largest portable cluster
DUC_STATIC_SMEM = 4 * 29          # the kernel's static duc::SlotLayout


@dataclasses.dataclass(frozen=True)
class DucGeometry:
    """duc::geometry of one (FIR, halfband) pair (csrc/duc_common.cuh)."""
    n1p: int
    kp: int
    off: int
    y_back: int
    x_back: int
    nz_tile: int
    hl: int           # timeline samples a symbol's window holds before it
    hr: int           # ... and after it
    b1: int           # FIR delay, lead zeros included
    j0: tuple         # halfband branch e holds g[j0_e + 2 k] ...
    kn: tuple         # ... for k < kn_e, after shift_e zero taps
    shift: tuple
    lead: int = 0     # zero taps before the FIR's first
    per: int = 4      # FIR outputs per thread


def duc_geometry(n1: int, n2: int, lead: int = 0,
                 per: int = 4) -> DucGeometry:
    b1, b2 = n1 - 1 - n1 // 2 + lead, n2 // 2 - 1
    j0 = tuple((e + b2) & 1 for e in range(2))
    dd = [(e + b2 - j0[e]) // 2 for e in range(2)]
    kn = tuple((n2 - j0[e] + 1) // 2 for e in range(2))
    d = max(dd)
    shift = tuple(d - x for x in dd)
    kp = _round_up4(max(kn[e] + shift[e] for e in range(2)))
    n1p = _round_up4(n1 + lead)
    y_back, x_back = kp - d, n1p - b1
    return DucGeometry(n1p=n1p, kp=kp, off=kp, y_back=y_back, x_back=x_back,
                       nz_tile=2 * ((DUC_THREADS * per - kp) & ~3),
                       hl=y_back + x_back, hr=b1 + d + 3, b1=b1, j0=j0,
                       kn=kn, shift=shift, lead=lead, per=per)


@dataclasses.dataclass(frozen=True)
class DucPlan:
    """How csrc/duc_from_spec.cu runs (duc_plan).

    Block g of antenna a serves symbol g of the waveform (g = 14 slot +
    symbol; blocks >= symbols pad the grid to whole clusters and emit
    nothing). The blocks form clusters of `cluster` consecutive symbols.
    Each block computes its own symbol's IDFT and publishes its CP
    timeline in the middle of its window; it takes its left halo (the
    last hl samples of symbol g - 1) and its right halo (the first hr of
    g + 1) from its neighbours' shared memory. A cluster's first block
    computes symbol g - 1's IDFT itself, its last block symbol g + 1's,
    and the waveform's two ends stay zero.

    tile_table, which the kernel reads: per symbol of a slot m, (tile,
    lo, hi): the symbol's 2 (cp + nfft) outputs go in tiles of `tile`
    (the last shorter), and tiles lo .. hi - 1 read no halo sample, so
    they run before the exchange. win (floats of each plane's window)
    and smem_bytes (dynamic shared memory) set the kernel's layout.
    """
    nant: int
    n_slots: int
    nfft: int
    n1: int
    n2: int
    cps: tuple
    cluster: int
    geometry: DucGeometry
    win: int
    smem_bytes: int
    tile_table: tuple

    @property
    def symbols(self) -> int:
        return 14 * self.n_slots

    @property
    def blocks(self) -> int:
        """Blocks per antenna: symbols padded to whole clusters."""
        return -(-self.symbols // self.cluster) * self.cluster

    def computes_outer(self, g: int) -> tuple[bool, bool]:
        """Whether block g computes its left / right neighbour's IDFT."""
        rank, n = g % self.cluster, self.symbols
        return (g < n and rank == 0 and g > 0,
                g + 1 < n and rank == self.cluster - 1)

    @property
    def idfts(self) -> int:
        """IDFTs per antenna, outer neighbours included."""
        return self.symbols + sum(sum(self.computes_outer(g))
                                  for g in range(self.blocks))

    @property
    def idfts_per_symbol(self) -> float:
        return self.idfts / self.symbols

    def tiles(self, g: int) -> tuple[list[tuple[int, int]], range]:
        """Symbol g's tiles as the kernel walks them from tile_table:
        [(first output, outputs)], and the indices of those that read no
        halo."""
        m = g % 14
        tile, lo, hi = self.tile_table[3 * m:3 * m + 3]
        n_out = 2 * (self.cps[m] + self.nfft)
        return ([(u, min(tile, n_out - u)) for u in range(0, n_out, tile)],
                range(lo, hi))


def _equal_tile(n_out: int, nz_tile: int) -> int:
    """Outputs per tile when n_out outputs go in equal tiles of at most
    nz_tile (a multiple of 8), multiples of 8 but the last."""
    n_tiles = -(-n_out // nz_tile)
    return (-(-n_out // n_tiles) + 7) // 8 * 8


def _tile_table(gm: DucGeometry, nfft: int, cps: tuple) -> tuple:
    """Per symbol of a slot: equal tiles of at most nz_tile outputs,
    multiples of 8 but the last, and the run of tiles that read no halo.
    A tile of outputs [u0, u0 + nz) reads its window from u0 / 2 on, n1p +
    round_up4(nz / 2 + off) floats (csrc/duc_common.cuh:fir_up2_tiles);
    the symbol's own samples are [hl, hl + cp + nfft)."""
    out = []
    for cp in cps:
        n_out = 2 * (cp + nfft)
        tile = _equal_tile(n_out, gm.nz_tile)
        free = [i for i, u0 in enumerate(range(0, n_out, tile))
                if u0 // 2 >= gm.hl and u0 // 2 + gm.n1p + _round_up4(
                    min(tile, n_out - u0) // 2 + gm.off) <= gm.hl + cp + nfft]
        out += [tile, free[0], free[-1] + 1] if free else [tile, 0, 0]
    return tuple(out)


def duc_plan(nant: int, n_slots: int, nfft: int, n1: int, n2: int, cps,
             cluster: int | None = None) -> DucPlan:
    """The launch of csrc/duc_from_spec.cu; raises (ValueError) where the
    shapes or a forced cluster size do not fit."""
    if not isinstance(cps, tuple):
        cps = tuple(int(c) for c in cps)
    return _duc_plan(nant, n_slots, nfft, n1, n2, cps,
                     DUC_CLUSTER if cluster is None else int(cluster))


@functools.lru_cache(maxsize=64)
def _duc_plan(nant: int, n_slots: int, nfft: int, n1: int, n2: int,
              cps: tuple, k: int) -> DucPlan:
    if not 1 <= k <= DUC_MAX_CLUSTER:
        raise ValueError(f"duc_from_spec: cluster {k} outside "
                         f"1..{DUC_MAX_CLUSTER}")
    if nant < 1 or n_slots < 1 or nfft < 4 or nfft & (nfft - 1) \
            or len(cps) != 14 or min(cps) < 0 or max(cps) > nfft:
        raise ValueError("duc_from_spec: needs nfft a power of two and 14 "
                         "CP lengths within [0, nfft]")
    gm = duc_geometry(n1, n2)
    if gm.nz_tile < 8 or max(gm.hl, gm.hr) > min(cps) + nfft:
        raise ValueError(f"duc_from_spec: {n1} + {n2} taps reach past the "
                         f"neighbouring symbols")
    win = _round_up4(gm.hl + max(cps) + nfft + gm.hr)
    # taps, two window planes, the IDFT's second buffer (later the two
    # planes' FIR intermediate)
    smem = 4 * (gm.n1p + 2 * gm.kp + 2 * win + 2 * max(nfft, DUC_TILE_Y))
    if smem + DUC_STATIC_SMEM > kernels.SMEM_OPTIN_BYTES:
        raise ValueError(f"duc_from_spec: {smem} bytes of shared memory per "
                         f"block do not fit")
    return DucPlan(nant=nant, n_slots=n_slots, nfft=nfft, n1=n1, n2=n2,
                   cps=cps, cluster=k, geometry=gm, win=win, smem_bytes=smem,
                   tile_table=_tile_table(gm, nfft, cps))


def checked_duc_plan(plan: DucPlan | None, nant: int, n_slots: int,
                     nfft: int, n1: int, n2: int, cps) -> DucPlan:
    """duc_plan's choice where plan is None; else plan itself, once
    duc_plan, forced to its cluster size, gives it back for these shapes
    (ValueError where it does not)."""
    if plan is None:
        return duc_plan(nant, n_slots, nfft, n1, n2, cps)
    if plan != duc_plan(nant, n_slots, nfft, n1, n2, cps, plan.cluster):
        raise ValueError(f"duc_from_spec: the plan was made for other "
                         f"shapes ({plan.nant} antennas, {plan.n_slots} "
                         f"slots, nfft {plan.nfft}, {plan.n1} + {plan.n2} "
                         f"taps)")
    return plan


# Launch choices of csrc/fir_up2_fused.cu and csrc/fir_up2_fused_symbols.cu
FUSED_PERS = (4, 8)               # FIR outputs per thread of the tile loop
FUSED_PER8_MIN_TAPS = 128         # 8 outputs per thread from this FIR on
FUSED_GROUPS = (1, 2)             # symbols per block
FUSED_GROUP_MIN_SAMPLES = 512     # default: 2 symbols per block below this
FUSED_MAX_RUNS = 2 * 14 + 4 * 14  # the symbols kernel's run table


def fused_lead(n1: int, n2: int) -> int:
    """Zero taps put before the FIR so that a tile's window starts on a
    multiple of 4 samples (hl a multiple of 4): each one moves hl by -1
    mod 4 (csrc/duc_common.cuh:geometry)."""
    return duc_geometry(n1, n2).hl % 4


def _window_floats(gm: DucGeometry, nz: int) -> int:
    """Window floats the tile loop reads for a tile of nz outputs: n1p +
    the FIR outputs, rounded to a thread's outputs."""
    return gm.n1p + -(-(nz // 2 + gm.off) // gm.per) * gm.per


def _phys_floats(gm: DucGeometry, win: int) -> int:
    """Shared floats of a window of win floats (a multiple of 4): for 8
    outputs per thread two halves of whole float4s, the window's even and
    odd float4s (duc_common.cuh:split)."""
    return -(-win // 8) * 8 if gm.per == 8 else win


def fused_tap_blob(fir_taps: np.ndarray, hb_taps: np.ndarray,
                   gm: DucGeometry) -> np.ndarray:
    """The packed taps the fused kernels copy in (duc_common.cuh:
    copy_taps): n1p FIR taps with gm.lead zeros first, then the two
    halfband branches of kp taps each, scaled by sqrt(2)."""
    h = np.zeros(gm.n1p)
    h[gm.lead:gm.lead + len(fir_taps)] = fir_taps
    g = np.asarray(hb_taps, np.float64) * np.sqrt(2)
    br = np.zeros((2, gm.kp))
    for e in range(2):
        br[e, gm.shift[e]:gm.shift[e] + gm.kn[e]] = \
            g[gm.j0[e]::2][:gm.kn[e]]
    return np.concatenate([h, br.ravel()]).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_tap_blob(fir_key: bytes, hb_key: bytes, lead: int,
                     device: torch.device) -> torch.Tensor:
    fir, hb = np.frombuffer(fir_key), np.frombuffer(hb_key)
    return torch.as_tensor(fused_tap_blob(
        fir, hb, duc_geometry(len(fir), len(hb), lead)), device=device)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How csrc/fir_up2_fused.cu runs (fused_plan).

    The 2T outputs of each plane go in tiles of geometry.nz_tile, one
    block each, in the flattened (plane, tile) order. Tile k's window holds `win`
    timeline samples from x_lo = z0/2 - hl on (zeros outside [0, T)),
    with hl a multiple of 4 (geometry.lead), copied in 16-byte chunks
    where vec, else sample by sample.
    """
    planes: int
    t: int
    n1: int
    n2: int
    geometry: DucGeometry
    tiles: int              # tiles per plane
    blocks: int
    vec: bool
    win: int
    smem_bytes: int

    @functools.cached_property
    def c_args(self) -> tuple:
        """The C entry's arguments after (x, taps, z)."""
        gm = self.geometry
        return (self.planes, self.t, self.n1, self.n2, gm.lead, gm.per,
                int(self.vec), self.win, self.smem_bytes)

    def tile(self, k: int) -> tuple[int, int, int, int]:
        """(plane, first output, outputs, first window sample) of tile k."""
        plane, i = divmod(k, self.tiles)
        z0 = i * self.geometry.nz_tile
        return (plane, z0, min(self.geometry.nz_tile, 2 * self.t - z0),
                z0 // 2 - self.geometry.hl)


@functools.lru_cache(maxsize=256)
def fused_plan(planes: int, t: int, n1: int, n2: int, aligned: bool = True,
               per: int | None = None) -> FusedPlan:
    """The launch of csrc/fir_up2_fused.cu over (planes, t) samples with n1
    FIR and n2 halfband taps. aligned: the input's base address is a
    multiple of 16 bytes (the wrapper checks its tensor's).

    One tile and one window per block; 8 outputs per thread for FIRs of
    FUSED_PER8_MIN_TAPS or more whose tiles give at least one block per
    SM, else 4 (more, smaller blocks). That is the tuner's choice
    (sim/time_filter_kernels.py --tune, PERF.md section 6): at 4x307200
    4 outputs per thread won at 71 and 87 taps, 8 at 143, 153 and 287
    (and from 4x1228800 on); 4 won at 2x15360. Blocks of several tiles,
    with or without a ring of two windows, were slower everywhere. per: a
    forced value (the tuner's and the card tests'); ValueError outside
    FUSED_PERS or where the shared memory does not fit."""
    if per is None:
        wide = duc_geometry(n1, n2, 0, 8).nz_tile
        per = 8 if (n1 >= FUSED_PER8_MIN_TAPS and planes * -(-2 * t // wide)
                    >= kernels.H100_SMS) else 4
    if not (per in FUSED_PERS and planes >= 0 and t >= 0 and n1 >= 1
            and n2 >= 3):
        raise ValueError(f"fir_up2_fused: {per} outputs per thread out of "
                         f"range")
    gm = duc_geometry(n1, n2, fused_lead(n1, n2), per)
    win = _window_floats(gm, gm.nz_tile)
    smem = 4 * (gm.n1p + 2 * gm.kp + DUC_THREADS * per
                + _phys_floats(gm, win))
    if gm.nz_tile < 8 or smem > kernels.SMEM_OPTIN_BYTES:
        raise ValueError(f"fir_up2_fused: {n1} + {n2} taps do not fit")
    tiles = -(-2 * t // gm.nz_tile)
    return FusedPlan(planes=planes, t=t, n1=n1, n2=n2, geometry=gm,
                     tiles=tiles, blocks=planes * tiles,
                     vec=bool(aligned and t % 4 == 0), win=win,
                     smem_bytes=smem)


def checked_fused_plan(plan: FusedPlan | None, planes: int, t: int, n1: int,
                       n2: int, aligned: bool) -> FusedPlan:
    """fused_plan's choice where plan is None; else plan itself, once
    fused_plan, forced to its choices, gives it back for these shapes and
    the input's alignment allows its staging (ValueError where not)."""
    if plan is None:
        return fused_plan(planes, t, n1, n2, aligned)
    if plan != fused_plan(planes, t, n1, n2, plan.vec, plan.geometry.per) \
            or (plan.vec and not aligned):
        raise ValueError(f"fir_up2_fused: the plan was made for other "
                         f"shapes ({plan.planes}x{plan.t}, {plan.n1} + "
                         f"{plan.n2} taps) or an aligned input")
    return plan


@dataclasses.dataclass(frozen=True)
class FusedSymbolsPlan:
    """How csrc/fir_up2_fused_symbols.cu runs (fused_symbols_plan).

    Block (j, p) serves group j % (14 / group) of slot s = j // (14 /
    group), `group` consecutive symbols of one slot, on plane p, with 4
    FIR outputs per thread. Its window holds the group's CP timeline with
    hl samples before it and hr after (zeros beyond the waveform), then
    zeros up to `win`, made of runs[j'] (j' the group in its slot):
    (window sample, symbol relative to the group's first, sample of that
    symbol's IFFT row, length, flags; flag 1: 16-byte copies, 2: zeros).
    The group's 2 len outputs go in equal tiles of tiles[j']
    (duc_from_spec's rule, _equal_tile).
    """
    planes: int
    n_slots: int
    nfft: int
    n1: int
    n2: int
    cps: tuple
    geometry: DucGeometry
    group: int
    starts: tuple           # first sample of each group in its slot, and
                            # slot_samples
    tiles: tuple
    runs: tuple
    win: int
    smem_bytes: int

    @property
    def groups(self) -> int:
        return 14 // self.group

    @property
    def slot_samples(self) -> int:
        return self.starts[-1]

    @property
    def blocks(self) -> int:
        return self.n_slots * self.groups * self.planes

    @functools.cached_property
    def table(self) -> np.ndarray:
        """The run table the C entry copies into the kernel's parameters:
        run_lo (groups + 1), starts (groups + 1), tiles (groups), runs."""
        run_lo = np.cumsum([0] + [len(r) for r in self.runs])
        flat = [x for rs in self.runs for run in rs for x in run]
        return np.ascontiguousarray(np.concatenate(
            [run_lo, self.starts, self.tiles, flat]), np.int32)

    @functools.cached_property
    def table_ptr(self) -> int:
        """Host address of table, for the C entry."""
        return self.table.ctypes.data

    @functools.cached_property
    def c_args(self) -> tuple:
        """The C entry's arguments after (sym, taps, z, table)."""
        gm = self.geometry
        return (self.planes, self.n_slots, self.nfft, self.slot_samples,
                self.n1, self.n2, self.geometry.lead, self.group,
                sum(len(r) for r in self.runs), self.win, self.smem_bytes)


def _group_runs(gm: DucGeometry, nfft: int, cps: tuple, m0: int, g: int,
                win: int, aligned: bool) -> tuple:
    """The runs of the window of symbols m0 .. m0 + g - 1 of a slot."""
    runs = [(0, -1, nfft - gm.hl, gm.hl)]             # symbol m0 - 1's tail
    at = gm.hl
    for i in range(g):
        cp = cps[m0 + i]
        if cp:
            runs.append((at, i, nfft - cp, cp))
        runs.append((at + cp, i, 0, nfft))
        at += cp + nfft
    cp = cps[(m0 + g) % 14]                            # the next symbol's
    runs.append((at, g, nfft - cp, min(gm.hr, cp)))   # CP and head
    if gm.hr > cp:
        runs.append((at + cp, g, 0, gm.hr - cp))
    out = [(dst, row, src, n,
            int(aligned and nfft % 4 == 0 and dst % 4 == 0 and src % 4 == 0
                and n % 4 == 0)) for dst, row, src, n in runs if n]
    end = at + gm.hr
    if win > end:
        out.append((end, 0, 0, win - end, 2))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def fused_symbols_plan(planes: int, n_slots: int, nfft: int, n1: int,
                       n2: int, cps: tuple, aligned: bool = True,
                       group: int | None = None) -> FusedSymbolsPlan:
    """The launch of csrc/fir_up2_fused_symbols.cu over (planes, n_slots,
    14, nfft) symbols with n1 FIR and n2 halfband taps. aligned: the
    input's base address is a multiple of 16 bytes.

    One symbol per block, or two where a symbol holds fewer than
    FUSED_GROUP_MIN_SAMPLES timeline samples (nfft 256) and the grid keeps
    two blocks per SM. The tuner's choice (sim/time_filter_kernels.py
    --tune, PERF.md section 6): at 20 slots two symbols per block won at
    nfft 256 and tied at nfft 512, one won at 1 slot. group (FUSED_GROUPS):
    a forced value; ValueError where it or the shapes do not fit (a halo
    longer than a symbol)."""
    if group is None:
        two = (nfft + max(cps) < FUSED_GROUP_MIN_SAMPLES
               and n_slots * 7 * planes >= 2 * kernels.H100_SMS)
        group = 2 if two else 1
    if group not in FUSED_GROUPS or planes < 0 or n_slots < 1 \
            or len(cps) != 14 or min(cps) < 0 or max(cps) > nfft \
            or n1 < 1 or n2 < 3:
        raise ValueError(f"fir_up2_fused_symbols: {group} symbols per "
                         f"block or the shapes out of range")
    gm = duc_geometry(n1, n2, fused_lead(n1, n2))
    if gm.nz_tile < 8 or gm.hl > nfft or gm.hr > min(cps) + nfft:
        raise ValueError(f"fir_up2_fused_symbols: {n1} + {n2} taps reach "
                         f"past the neighbouring symbols")
    starts = tuple(int(x) for x in np.cumsum(
        [0] + [sum(cps[m] + nfft for m in range(j, j + group))
               for j in range(0, 14, group)]))
    tiles, win = [], 0
    for j in range(14 // group):
        n_out = 2 * (starts[j + 1] - starts[j])
        tile = _equal_tile(n_out, gm.nz_tile)
        tiles.append(tile)
        win = max([win, gm.hl + n_out // 2 + gm.hr] + [
            u0 // 2 + _window_floats(gm, min(tile, n_out - u0))
            for u0 in range(0, n_out, tile)])
    win = _round_up4(win)
    runs = tuple(_group_runs(gm, nfft, cps, m0, group, win, aligned)
                 for m0 in range(0, 14, group))
    smem = 4 * (gm.n1p + 2 * gm.kp + DUC_TILE_Y + win)
    if smem > kernels.SMEM_OPTIN_BYTES:
        raise ValueError(f"fir_up2_fused_symbols: {smem} bytes of shared "
                         f"memory per block do not fit")
    return FusedSymbolsPlan(planes=planes, n_slots=n_slots, nfft=nfft, n1=n1,
                            n2=n2, cps=cps, geometry=gm, group=group,
                            starts=starts, tiles=tuple(tiles), runs=runs,
                            win=win, smem_bytes=smem)


def checked_fused_symbols_plan(plan: FusedSymbolsPlan | None, planes: int,
                               n_slots: int, nfft: int, n1: int, n2: int,
                               cps: tuple, aligned: bool
                               ) -> FusedSymbolsPlan:
    """fused_symbols_plan's choice where plan is None; else plan itself,
    once fused_symbols_plan, forced to its choices, gives it back for these
    shapes and the input's alignment (ValueError where it does not)."""
    if plan is None:
        return fused_symbols_plan(planes, n_slots, nfft, n1, n2, cps,
                                  aligned)
    vec = any(r[4] & 1 for rs in plan.runs for r in rs)
    if (vec and not aligned) or plan not in (
            fused_symbols_plan(planes, n_slots, nfft, n1, n2, cps, a,
                               plan.group)
            for a in (True, False)):
        raise ValueError(f"fir_up2_fused_symbols: the plan was made for "
                         f"other shapes ({plan.planes} planes, "
                         f"{plan.n_slots} slots, nfft {plan.nfft}, "
                         f"{plan.n1} + {plan.n2} taps) or an aligned input")
    return plan


def _duc_from_spec(spec_planes: torch.Tensor, cps, fir_taps: np.ndarray,
                   hb_taps: np.ndarray, phase_comp: np.ndarray,
                   plan: DucPlan | None = None) -> torch.Tensor:
    """duc_from_spec_planes with both output planes in one (2*ant, T2)
    tensor (real planes first). plan: a forced duc_plan (checked)."""
    cps = tuple(map(int, cps))
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
    plan = checked_duc_plan(plan, p2 // 2, s, nfft, len(fir_taps),
                            len(hb_taps), cps)
    slot_samples = sum(cps) + 14 * nfft
    dev = spec_planes.device
    h, g = _fused_taps(fir_taps, hb_taps, dev)
    # (re, im) of each symbol's factor, interleaved
    pc = np.ascontiguousarray(phase_comp, np.complex64).view(np.float32)
    z = torch.empty((p2, 2 * s * slot_samples), dtype=torch.float32,
                    device=dev)
    fn = kernels.library("duc_from_spec").duc_from_spec
    rc = fn(spec_planes.data_ptr(), _device_ints(cps, dev).data_ptr(),
            _device_ints(plan.tile_table, dev).data_ptr(),
            _device_floats(pc.tobytes(), dev).data_ptr(),
            _device_floats(_twiddles(nfft), dev).data_ptr(), h.data_ptr(),
            g.data_ptr(), z.data_ptr(), p2 // 2, s, nfft, slot_samples,
            len(fir_taps), len(hb_taps), plan.cluster, plan.win,
            plan.smem_bytes, _stream(spec_planes))
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
