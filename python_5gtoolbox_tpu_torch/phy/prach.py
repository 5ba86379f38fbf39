"""PRACH: preamble formats 0-2 (LRA=839) and A1..C2 (LRA=139), TS 38.211 6.3.3.

Port of python_5gtoolbox_tpu/phy/prach.py: ZC root cycling and Ncs
zones (logical -> physical root tables from data npz), the
configuration tables 38.211 6.3.3.2-2/3 (data json), the format timing
with the n*16 CP extension rule, the Prach object (its own 1.25/5/15/30
kHz numerology: IFFT, frequency shift and CP at a fixed 30.72 Msps) and
the PRACH waveform.

The preamble of an SFN is host work in complex128, as in the JAX
package, cast to complex64. The halfband x2 upsampling of
gen_prach_waveform runs on the waveform's device: each stage is one
ops/filters.py:banded_fir `up2` launch over every SFN at once (the SFNs'
real and imaginary parts stacked as planes). The PRACH chain has no
sqrt(2) gain and takes upfirdn's slice from n//2, where the `up2` stage
has a gain of sqrt(2) and starts at n//2 - 1: the 55-tap halfband with
one trailing zero tap (56 taps) scaled by 1/sqrt(2) is the same
filter in the `up2` convention.
"""
from __future__ import annotations

import functools
import json
import math
import pathlib

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import on_device, resolve_device
from python_5gtoolbox_tpu_torch.ops import filters
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data"

# 38.211 Tables 6.3.3.1-5 / 6.3.3.1-7 (Ncs for unrestricted sets).
_NCS_LONG = [0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279,
             419]
_NCS_SHORT = [0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69]

_FORMAT_INFO = {
    "0": (24576, 3168), "1": (2 * 24576, 21024), "2": (4 * 24576, 4688),
    "A1": (2 * 2048, 288), "A2": (4 * 2048, 576), "A3": (6 * 2048, 864),
    "B1": (2 * 2048, 216), "B2": (4 * 2048, 360), "B3": (6 * 2048, 504),
    "B4": (12 * 2048, 936), "C0": (2048, 1240), "C2": (4 * 2048, 2048),
}

PRACH_RATE_KHZ = 30720      # samples per ms of Prach.process's waveform


@functools.lru_cache(maxsize=None)
def _root_tables():
    with np.load(_DATA / "prach_root_sequences.npz") as z:
        return z["short"].copy(), z["long"].copy()


@functools.lru_cache(maxsize=None)
def _config_table(duplex: str):
    name = "prach_config_fr1_tdd.json" if duplex == "TDD" \
        else "prach_config_fr1_fdd.json"
    with open(_DATA / name) as f:
        return json.load(f)


def get_ncs(lra: int, zone_cfg: int) -> int:
    return (_NCS_LONG if lra == 839 else _NCS_SHORT)[zone_cfg]


def get_sequence_number(lra: int, logical_idx: int) -> int:
    short, long_ = _root_tables()
    return int((long_ if lra == 839 else short)[logical_idx])


def prach_seq_gen(root_seq_idx: int, lra: int, zone_cfg: int,
                  preamble_idx: int) -> np.ndarray:
    """Frequency-domain preamble y_uv (38.211 6.3.3.1), complex128."""
    ncs = get_ncs(lra, zone_cfg)
    per_zc = 1 if ncs == 0 else lra // ncs
    if per_zc >= 64:
        logical = root_seq_idx
        v = preamble_idx
    else:
        for m in range(math.ceil(64 / per_zc)):
            if per_zc * (m + 1) > preamble_idx:
                logical = root_seq_idx + m
                if logical > lra - 2:
                    logical -= lra - 1
                v = preamble_idx - per_zc * m
                break
    u = get_sequence_number(lra, logical)
    n = np.arange(lra)
    xu = np.exp(-1j * np.pi * u * n * (n + 1) / lra)
    cv = v * ncs
    xuv = np.roll(xu, -cv)
    return np.fft.fft(xuv)


def get_kbar_nrarb(lra: int, prach_fra, carrier_scs: int):
    if lra == 839:
        return (7, 6) if carrier_scs == 15 else (1, 3)
    nrarb = {(15, 15): 12, (15, 30): 6, (30, 15): 24, (30, 30): 12}[
        (prach_fra, carrier_scs)]
    return 2, nrarb


def get_prach_config_info(cfg_index: int, duplex: str) -> dict:
    row = _config_table(duplex)[cfg_index]
    assert row[0] == cfg_index
    return dict(preamble_formats=row[1], x=row[2], y=row[3],
                subframe_numbers=row[4], start_symbol=row[5],
                nprachslot_insubframe=row[6], NRASlot_t=row[7],
                NRA_dur=row[8])


def get_prach_format_info(fmt: str, msg1_scs):
    assert fmt != "3", "format 3 not supported (as reference)"
    lra = 839 if fmt in ("0", "1", "2", "3") else 139
    nu, cp = _FORMAT_INFO[fmt]
    if msg1_scs == 30:
        nu //= 2
        cp //= 2
    return lra, nu, cp


_SCS15_SYM = [2208] + [2192] * 6 + [2208] + [2192] * 6
_SCS30_SYM = [1112] + [1096] * 13


def get_prach_txinfo(fmt, active_slot, nra_t, start_symbol, nslot_insub,
                     msg1_scs, nu, cp, nra_dur):
    """(nRA_slot, first_symbol, CP length with n*16 rule, tRA_start)."""
    if fmt in ("0", "1", "2", "3"):
        first = start_symbol
        return 0, first, cp, sum(_SCS15_SYM[:first])
    if msg1_scs == 15:
        nra_slot = 0
    elif nslot_insub == 1:
        nra_slot = 1
    else:
        nra_slot = active_slot
    first = start_symbol + nra_t * nra_dur + 14 * nra_slot
    if msg1_scs == 15:
        t_start = sum(_SCS15_SYM[:first])
    else:
        if first >= 14:
            t_start = sum(_SCS30_SYM[: first - 14]) + 30720 // 2
        else:
            t_start = sum(_SCS30_SYM[:first])
    t_last = t_start + nu + cp
    n = 0
    if t_start == 0:
        n += 1
        if t_last >= 15360:
            n += 1
    elif t_start <= 15360 and t_last >= 15360:
        n += 1
    return nra_slot, first, cp + n * 16, t_start


class Prach:
    """PRACH channel object, reference-compatible process(sfn)."""

    def __init__(self, carrier_config: dict, prach_config: dict,
                 prach_parameter: dict):
        self.carrier = carrier_config
        self.cfg = prach_config
        self.par = prach_parameter
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        info = get_prach_config_info(prach_config["prach_ConfigurationIndex"],
                                     carrier_config["duplex_type"])
        fmts = info["preamble_formats"]
        if len(fmts) == 1:
            fmt = fmts[0]
        else:
            last = prach_parameter["nRA_t"] == info["NRASlot_t"] - 1
            fmt = fmts[1] if last else fmts[0]
        self.fmt = fmt
        msg1_scs = prach_config["msg1_SubcarrierSpacing"]
        if fmt in ("0", "1", "2"):
            msg1_scs = 1.25
        elif fmt == "3":
            msg1_scs = 5
        self.msg1_scs = msg1_scs
        lra, nu, cp = get_prach_format_info(fmt, msg1_scs)
        info.update(LRA=lra, Nu=nu, NRA_CP=cp)
        kbar, nrarb = get_kbar_nrarb(lra, msg1_scs, carrier_config["scs"])
        info.update(kbar=kbar, NRARB=nrarb)
        self.info = info
        K = carrier_config["scs"] / msg1_scs
        k1 = (prach_config["msg1_FrequencyStart"] * 12
              + prach_parameter["nRA"] * nrarb * 12 - self.prb_size * 12 // 2)
        assert prach_parameter["nRA"] < prach_config["msg1_FDM"]
        self.freq_shift = K * k1 + kbar
        nra_slot, first, cp_l, t_start = get_prach_txinfo(
            fmt, prach_parameter["ActivePRACHslotinSubframe"],
            prach_parameter["nRA_t"], info["start_symbol"],
            info["nprachslot_insubframe"], msg1_scs, nu, cp,
            info["NRA_dur"])
        self.nra_slot, self.first_symbol = nra_slot, first
        self.cp_l, self.t_start = cp_l, t_start

    def is_active(self, sfn: int) -> bool:
        return (sfn % self.info["x"] == self.info["y"]
                and self.par["PRACH_subframe"] in
                self.info["subframe_numbers"])

    @functools.cached_property
    def preamble(self) -> np.ndarray:
        """The preamble with its CP at 30.72 Msps (complex128: ZC
        sequence, DFT, IFFT, frequency shift, repetitions), the same in
        every active SFN."""
        fs_k = PRACH_RATE_KHZ
        yuv = prach_seq_gen(self.cfg["prach_RootSequenceIndex"],
                            self.info["LRA"],
                            self.cfg["zeroCorrelationZoneConfig"],
                            self.par["PreambleIndex"])
        ifft_size = int(fs_k / self.msg1_scs)
        lra, nu = self.info["LRA"], self.info["Nu"]
        if lra == 839:
            reps = nu // 24576
        elif self.msg1_scs == 15:
            reps = nu // 2048
        else:
            reps = nu // 1024
        buf = np.concatenate([yuv, np.zeros(ifft_size - lra)])
        td = np.fft.ifft(buf) * math.sqrt(ifft_size)
        ramp = np.exp(1j * 2 * np.pi * self.freq_shift * self.msg1_scs
                      * np.arange(ifft_size) / fs_k)
        td = np.tile(td * ramp, reps)
        return np.concatenate([td[-self.cp_l:], td])

    def process(self, sfn: int):
        """-> (10 ms waveform at 30.72 Msps, complex64 numpy; prach_data,
        the preamble's subframes, or []; active 0/1). Host numpy."""
        fs_k = PRACH_RATE_KHZ
        waveform = np.zeros(fs_k * 10, np.complex64)
        if not self.is_active(sfn):
            return waveform, [], 0
        sub = self.par["PRACH_subframe"]
        with_cp = self.preamble
        start = sub * fs_k + self.t_start
        waveform[start: start + with_cp.size] = with_cp
        sel = math.ceil((self.t_start + with_cp.size) / fs_k) * fs_k
        prach_data = waveform[sub * fs_k: sub * fs_k + sel]
        return waveform, prach_data, 1


@functools.lru_cache(maxsize=None)
def prach_halfband() -> np.ndarray:
    """The 55-tap halfband plus one zero tap, over sqrt(2): the PRACH
    chain's x2 stage (offset n//2, gain 1) as a banded_fir `up2` stage
    (offset n//2 - 1, gain sqrt(2))."""
    return np.append(filters.halfband_coeff(), 0.0) / np.sqrt(2)


def prach_upsample(x, reps: int) -> torch.Tensor:
    """x2^reps halfband upsampling with the PRACH offset convention
    (upfirdn slice [n//2 : n//2 + 2len], no sqrt(2) gain): (..., T)
    complex, a tensor (its device) or numpy (-> cuda) -> (..., T * 2^reps)
    complex64. Each stage is one banded_fir `up2` over every row's real
    and imaginary plane (banded_fir_plain on a CPU tensor)."""
    xc = on_device(x).to(torch.complex64)
    lead, t = xc.shape[:-1], xc.shape[-1]
    xc = xc.reshape(-1, t)
    planes = torch.cat([xc.real, xc.imag]).contiguous()
    for _ in range(reps):
        planes = filters.banded_fir(planes, prach_halfband(), "up2")
    m = xc.shape[0]
    return torch.complex(planes[:m], planes[m:]).reshape(
        lead + (planes.shape[-1],))


def gen_prach_waveform(waveform_config, carrier_config, prach_config,
                       prach_parameters, device=None):
    """10 ms per SFN of PRACH waveform at waveform_config's sample rate ->
    (td (1, n_sfn * rate/100) complex64, prach_data_list (active SFNs,
    samples) complex64 or an empty (0, 0) tensor), on device (None ->
    cuda).

    n_sfn = ceil(numofslots * scs / 15 / 10), as the JAX package counts
    them (prach.py:254; four SFNs for the 20 slots of one scs 30 frame).
    The preambles are built on the host and go to the device once; the
    upsampling runs there, every SFN in one banded_fir launch per stage.
    """
    dev = resolve_device(device)
    fs_mhz = waveform_config["samplerate_in_mhz"]
    start_sfn = waveform_config["startSFN"]
    n_sfn = math.ceil(waveform_config["numofslots"] * carrier_config["scs"]
                      / 15 / 10)
    per_sfn = int(fs_mhz * 1e6) // 100
    reps = int(np.log2(int(fs_mhz / 30.72)))
    if per_sfn != PRACH_RATE_KHZ * 10 << reps:
        raise ValueError(f"sample rate {fs_mhz} MHz is not 30.72 MHz "
                         f"times a power of two")
    prach = Prach(carrier_config, prach_config, prach_parameters)
    wavs, datas = [], []
    for m in range(n_sfn):
        wav, data, active = prach.process(m + start_sfn)
        wavs.append(wav)
        if active:
            datas.append(data)
    td = prach_upsample(torch.as_tensor(np.stack(wavs), device=dev), reps)
    data = torch.as_tensor(np.vstack(datas), device=dev) if datas \
        else torch.zeros((0, 0), dtype=torch.complex64, device=dev)
    return td.reshape(1, -1), data
