"""Pipeline-parallel TX waveform: the OFDM and DUC stages overlapped.

Port of python_5gtoolbox_tpu/parallel/pipeline.py. The slot axis is cut
into chunks; stage A (batched OFDM of a chunk, ofdm.tx_low_phy) and stage
B (the DUC of a chunk extended by _halo true neighbour samples per side)
run on devices[0] and devices[1]. Stage B's chunk i needs chunk i + 1's
first samples, so it waits on stage A's event for chunk i + 1: a one-chunk
lookahead. When both stages land on one card they run on two CUDA
streams of it; on two cards each stage runs on its own; on the CPU the
stages run one after the other.

Stage B's first two steps are one fir_up2_fused launch (FIR `same` and
the first halfband x2, the FIR output truncated to the extended chunk)
where that is the chain's own mask: on every chunk that does not touch
the waveform's edges. At an edge the serial chain truncates the FIR
output to the waveform, so the chunk's FIR output is zeroed over the
edge-side halo (mask_edges) between a banded_fir `same` and a banded_fir
`up2`. Further halfband stages are banded_fir `up2`, masked the same
way. The chunks' outputs, trimmed of their halos, equal the unchunked
serial_tx_waveform.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import filters, ofdm
from python_5gtoolbox_tpu_torch.utils import numerology as num


def _halo(scs: int, bw: int, out_rate_hz: float) -> int:
    """Per-side 1x-rate halo covering the FIR + halfband chain reach."""
    n_fir = len(filters.fir_coeff(scs, bw))
    fs_in = num.fft_size(num.carrier_prb_size(scs, bw)) * scs * 1000
    n_hb = max(int(np.log2(round(out_rate_hz / fs_in))), 0)
    # fir reach n//2; each x2 stage adds <= |hb|/2 at its input rate
    return n_fir // 2 + 32 * max(n_hb, 1)


def _stage_ofdm(fd_chunk: torch.Tensor, scs: int, bw: int, fc_hz: int):
    """(ant, S, 14, n_sc) -> (ant, S * slot_samples) complex64."""
    td = ofdm.tx_low_phy(fd_chunk, scs, bw, fc_hz, roll_ant=False)
    return td.reshape(td.shape[0], -1)


def _mask_edges(y: torch.Tensor, h: int, edge_l: bool, edge_r: bool):
    if edge_l:
        y[..., :h] = 0
    if edge_r:
        y[..., y.shape[-1] - h:] = 0
    return y


def _stage_duc(x_ext: torch.Tensor, scs: int, bw: int, out_rate_hz: float,
               trim: int, halo: int, edge_l: bool, edge_r: bool):
    """DUC of a halo-extended chunk (ant, T_ext) -> (ant, ratio * T) on
    real planes; at the waveform's edges the FIR output's halo is zeroed
    as the serial chain's truncation does."""
    n_hb = int(np.log2(filters._oversample(scs, bw, out_rate_hz)))
    fir, hb = filters.fir_coeff(scs, bw), filters.halfband_coeff()
    nant = x_ext.shape[0]
    y = torch.cat([x_ext.real, x_ext.imag]).contiguous()
    if n_hb and not (edge_l or edge_r):
        y = filters.fir_up2_fused_planes(y, fir, hb)
    else:
        y = _mask_edges(filters.banded_fir(y, fir, "same"), halo, edge_l,
                        edge_r)
        if n_hb:
            y = filters.banded_fir(y, hb, "up2")
    for k in range(1, n_hb):
        y = filters.banded_fir(
            _mask_edges(y, halo * 2 ** k, edge_l, edge_r), hb, "up2")
    y = y[..., trim: y.shape[-1] - trim]
    return torch.complex(y[:nant], y[nant:])


def _default_devices() -> list:
    resolve_device(None)
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def pipelined_tx_waveform(fd_slots, scs: int, bw: int, fc_hz: int,
                          out_rate_hz: float, devices=None,
                          chunk_slots: int = 4) -> torch.Tensor:
    """(ant, S, 14, n_sc) grids (numpy or a tensor) -> (ant, oversample *
    S * slot_samples) complex64 waveform on devices[1 % len(devices)]:
    OFDM on devices[0], DUC on devices[1 % len(devices)] (default: every
    card), chunks of `chunk_slots` slots flowing through both stages."""
    devices = [torch.device(d) for d in (devices or _default_devices())]
    d_a, d_b = devices[0], devices[1 % len(devices)]
    nant, n_slots = fd_slots.shape[0], fd_slots.shape[1]
    ratio = filters._oversample(scs, bw, out_rate_hz)
    halo = _halo(scs, bw, out_rate_hz)
    n_chunks = -(-n_slots // chunk_slots)
    fd = torch.as_tensor(fd_slots)
    zeros = torch.zeros((nant, halo), dtype=torch.complex64, device=d_b)
    cuda = d_a.type == "cuda"
    if cuda:
        s_a, s_b = torch.cuda.Stream(d_a), torch.cuda.Stream(d_b)
        s_a.wait_stream(torch.cuda.current_stream(d_a))
        s_b.wait_stream(torch.cuda.current_stream(d_b))

    # stage A: every chunk up front, one event after each
    tds, done = [], []
    for i in range(n_chunks):
        chunk = fd[:, i * chunk_slots:(i + 1) * chunk_slots]
        if cuda:
            with torch.cuda.stream(s_a):
                tds.append(_stage_ofdm(chunk.to(d_a, non_blocking=True),
                                       scs, bw, fc_hz))
                done.append(torch.cuda.Event())
                done[-1].record(s_a)
        else:
            tds.append(_stage_ofdm(chunk.to(d_a), scs, bw, fc_hz))

    # stage B: chunk i starts once chunk i + 1 is out of stage A
    outs = []
    for i in range(n_chunks):
        ctx = torch.cuda.stream(s_b) if cuda else contextlib.nullcontext()
        with ctx:
            if cuda:
                s_b.wait_event(done[min(i + 1, n_chunks - 1)])
            own = tds[i].to(d_b)
            left = tds[i - 1][..., -halo:].to(d_b) if i > 0 else zeros
            right = tds[i + 1][..., :halo].to(d_b) if i + 1 < n_chunks \
                else zeros
            x_ext = torch.cat([left, own, right], dim=-1)
            outs.append(_stage_duc(x_ext, scs, bw, out_rate_hz,
                                   trim=ratio * halo, halo=halo,
                                   edge_l=(i == 0),
                                   edge_r=(i == n_chunks - 1)))
    if cuda:
        for t in tds:
            t.record_stream(s_b)
        with torch.cuda.stream(s_b):
            out = torch.cat(outs, dim=-1)
        torch.cuda.current_stream(d_b).wait_stream(s_b)
        out.record_stream(torch.cuda.current_stream(d_b))
        return out
    return torch.cat(outs, dim=-1)


def serial_tx_waveform(fd_slots, scs: int, bw: int, fc_hz: int,
                       out_rate_hz: float, device=None) -> torch.Tensor:
    """The unchunked chain on one device (None: the card): OFDM, then
    filters.tx_channel_filter."""
    fd = torch.as_tensor(fd_slots, device=resolve_device(device))
    td = _stage_ofdm(fd, scs, bw, fc_hz)
    return filters.tx_channel_filter(td, scs, bw, out_rate_hz)
