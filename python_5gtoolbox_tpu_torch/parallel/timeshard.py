"""Time-axis (sample) sharding of the channel filter: overlap-save.

Port of python_5gtoolbox_tpu/parallel/timeshard.py. Each rank holds one
contiguous block of the sample axis. Before every FIR or halfband stage
it sends its edges to its ring neighbours (dist.batch_isend_irecv) and
receives theirs; the ranks at the ends of the stream take zeros, which
is the unsharded filter's zero padding. The stage is then one banded_fir
launch (csrc/banded_fir.cu on a CUDA block, its plain version on a CPU
one) over the halo-extended block, and a slice of it is the rank's block
of the global output: banded_fir's `same`, `up2` and `down2` over the
extended block are aligned with the global stage's output, offset by the
left halo (twice it after `up2`, half of it after `down2`). So the
sharded chain is sample-exact against ops.filters.tx_channel_filter /
rx_channel_filter.

The blocks stay on their device as real planes (real parts first) from
the first stage to the last. Only the halos move: under nccl as device
tensors, under gloo (which sends host tensors only) through the host,
a few hundred samples per plane and stage.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from python_5gtoolbox_tpu_torch.ops import filters
from python_5gtoolbox_tpu_torch.parallel.mesh import axis_group


def _halo_exchange(x: torch.Tensor, hl: int, hr: int, mesh, axis
                   ) -> torch.Tensor:
    """(P, Tb) local planes -> (P, hl + Tb + hr): the left neighbour's last
    hl samples, x, the right neighbour's first hr samples; zeros at the
    ends of the stream."""
    group, n, r = axis_group(mesh, axis)
    if x.shape[-1] < max(hl, hr):
        raise ValueError(
            f"per-device block of {x.shape[-1]} samples is smaller than the "
            f"filter halo ({max(hl, hr)}); give each of the {n} devices at "
            f"least max(hl, hr) samples (use fewer shards or longer input)")
    host = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    wire = torch.device("cpu") if host else x.device

    def peer(k):
        return dist.get_global_rank(group, k)

    left = torch.zeros(x.shape[:-1] + (hl,), dtype=x.dtype, device=wire)
    right = torch.zeros(x.shape[:-1] + (hr,), dtype=x.dtype, device=wire)
    ops = []
    if hl and r + 1 < n:
        ops.append(dist.P2POp(dist.isend, x[..., -hl:].contiguous().to(wire),
                              peer(r + 1), group))
    if hl and r > 0:
        ops.append(dist.P2POp(dist.irecv, left, peer(r - 1), group))
    if hr and r > 0:
        ops.append(dist.P2POp(dist.isend, x[..., :hr].contiguous().to(wire),
                              peer(r - 1), group))
    if hr and r + 1 < n:
        ops.append(dist.P2POp(dist.irecv, right, peer(r + 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([left.to(x.device), x, right.to(x.device)], dim=-1)


def _os_fir_same(x: torch.Tensor, taps: np.ndarray, mesh, axis):
    """Overlap-save 'same' FIR: this rank's block of the global
    fir_same output."""
    n = len(taps)
    hl = n // 2
    xh = _halo_exchange(x, hl, n - 1 - hl, mesh, axis)
    return filters.banded_fir(xh, taps, "same")[..., hl: hl + x.shape[-1]]


def _os_hb_up2(x: torch.Tensor, taps: np.ndarray, mesh, axis):
    """Overlap-save halfband x2 upsampler: this rank's block of the global
    hb_upsample2 output. The halos are the JAX module's, in input
    samples: ceil(pad_l / 2) left, ceil((n - 1 - pad_l) / 2) + 1 right,
    pad_l = (n - 1) - (n//2 - 1)."""
    n = len(taps)
    pad_l = (n - 1) - (n // 2 - 1)
    hl = -(-pad_l // 2)
    hr = -(-(n - 1 - pad_l) // 2) + 1
    tb = x.shape[-1]
    xh = _halo_exchange(x, hl, hr, mesh, axis)
    return filters.banded_fir(xh, taps, "up2")[..., 2 * hl: 2 * (hl + tb)]


def _os_hb_down2(x: torch.Tensor, taps: np.ndarray, mesh, axis):
    """Overlap-save halfband /2 decimator: this rank's block of the global
    hb_downsample2 output (the block length must be even). The left halo
    is rounded up to an even count so the extended block keeps the
    global output's phase."""
    n = len(taps)
    shift = 2 * ((n + 1) // 4)
    hl, hr = (n - 1) - shift, shift - 1
    hl += hl & 1
    xh = _halo_exchange(x, hl, hr, mesh, axis)
    return filters.banded_fir(xh, taps, "down2")[
        ..., hl // 2: hl // 2 + x.shape[-1] // 2]


def _planes(x: torch.Tensor) -> tuple[torch.Tensor, tuple, int]:
    lead = x.shape[:-1]
    xc = x.to(torch.complex64).reshape(-1, x.shape[-1])
    return torch.cat([xc.real, xc.imag]).contiguous(), lead, xc.shape[0]


def _complex(y: torch.Tensor, lead: tuple, m: int) -> torch.Tensor:
    return torch.complex(y[:m], y[m:]).reshape(lead + (y.shape[-1],))


def sharded_tx_channel_filter(td: torch.Tensor, scs: int, bw: int,
                              mesh=None, axis="sp",
                              out_rate_hz: float = 245.76e6) -> torch.Tensor:
    """This rank's block (ant..., Tb) of the carrier-rate stream ->
    its block (ant..., Tb * oversample) of tx_channel_filter's output:
    the FIR, then each halfband x2 stage, with halos from the ranks of
    mesh[axis] (mesh None: every rank), whose blocks are contiguous in
    rank order."""
    n_hb = int(np.log2(filters._oversample(scs, bw, out_rate_hz)))
    y, lead, m = _planes(td)
    y = _os_fir_same(y, filters.fir_coeff(scs, bw), mesh, axis)
    for _ in range(n_hb):
        y = _os_hb_up2(y, filters.halfband_coeff(), mesh, axis)
    return _complex(y, lead, m)


def sharded_rx_channel_filter(rx: torch.Tensor, scs: int, bw: int,
                              mesh=None, axis="sp",
                              in_rate_hz: float = 245.76e6) -> torch.Tensor:
    """DDC mirror: this rank's block (ant..., Tb) at in_rate_hz -> its
    block of rx_channel_filter's output; Tb must be a multiple of the
    total decimation 2**stages."""
    n_hb = int(np.log2(filters._oversample(scs, bw, in_rate_hz)))
    if rx.shape[-1] % (1 << n_hb):
        raise ValueError(f"block of {rx.shape[-1]} samples is not a multiple "
                         f"of the decimation {1 << n_hb}")
    y, lead, m = _planes(rx)
    for _ in range(n_hb):
        y = _os_hb_down2(y, filters.halfband_coeff(), mesh, axis)
    y = _os_fir_same(y, filters.fir_coeff(scs, bw), mesh, axis)
    return _complex(y, lead, m)
