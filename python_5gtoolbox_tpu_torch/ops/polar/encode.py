"""Polar encoder, TS 38.212 5.3.1, batched over codewords.

Port of python_5gtoolbox_tpu/ops/polar/encode.py: optional K-interleaver,
frozen and parity-check bit insertion, then x = u G_N as log2(N) XOR
butterfly stages. The parity-check register is resolved at plan time: the
PC bit at position p is the XOR of the info bits already placed at
positions q < p with q = p (mod 5), a static subset per PC bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.polar.construct import construct
from python_5gtoolbox_tpu_torch.ops.polar.interleave import \
    input_interleave_table


@functools.lru_cache(maxsize=None)
def _u_plan(K: int, E: int, n_max: int, i_il: int):
    """(N, info_pos (K,), pc_pos (nPC,), pc_sources: per PC bit the
    indices into the interleaved input, interleave table or None)."""
    F, qpc, N, _, _ = construct(K, E, n_max)
    qpc_set = {int(x) for x in qpc}
    info_pos = [i for i in range(N) if F[i] == 0 and i not in qpc_set]
    assert len(info_pos) == K
    pc_pos = sorted(int(x) for x in qpc)
    pc_sources = [np.asarray([k for k, q in enumerate(info_pos)
                              if q < p and q % 5 == p % 5], np.int64)
                  for p in pc_pos]
    itrl = input_interleave_table(K) if i_il else None
    return (N, np.asarray(info_pos, np.int64), pc_pos, pc_sources, itrl)


def butterfly(u: torch.Tensor) -> torch.Tensor:
    """x = u G_N over GF(2): log2(N) XOR stages. u: (..., N) int8."""
    N = u.shape[-1]
    x = u
    for s in range(N.bit_length() - 1):
        h = 1 << s
        x = x.reshape(x.shape[:-1] + (N // (2 * h), 2, h))
        x = torch.stack([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-2)
        x = x.reshape(x.shape[:-3] + (N,))
    return x


def polar_encode(bits: torch.Tensor, E: int, n_max: int, i_il: int
                 ) -> torch.Tensor:
    """(..., K) info + CRC bits -> (..., N) int8 polar codeword."""
    K = bits.shape[-1]
    N, info_pos, pc_pos, pc_sources, itrl = _u_plan(K, E, n_max, i_il)
    dev = bits.device
    b = bits.to(torch.int8)
    if itrl is not None:
        b = b[..., torch.as_tensor(itrl, device=dev).long()]
    u = b.new_zeros(b.shape[:-1] + (N,))
    u[..., torch.as_tensor(info_pos, device=dev)] = b
    for p, src in zip(pc_pos, pc_sources):
        u[..., p] = (b[..., torch.as_tensor(src, device=dev)]
                     .to(torch.int32).sum(-1) % 2).to(torch.int8)
    return butterfly(u)


def polar_encode_np(bits: np.ndarray, E: int, n_max: int, i_il: int
                    ) -> np.ndarray:
    """Host helper: (K,) bits -> (N,) int8 codeword."""
    return polar_encode(torch.as_tensor(np.asarray(bits, np.int8)[None]),
                        E, n_max, i_il)[0].numpy()
