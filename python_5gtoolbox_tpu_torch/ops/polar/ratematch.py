"""Polar rate matching and recovery, TS 38.212 5.4.1.

Port of python_5gtoolbox_tpu/ops/polar/ratematch.py: sub-block
interleave, repetition / puncturing / shortening bit selection and the
iBIL triangular channel interleaver as one host gather table, and the
LLR-domain inverse (puncture -> LLR 0, shorten -> +llr_limit, repetition
-> LLR accumulation).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.polar.construct import subblock_jn
from python_5gtoolbox_tpu_torch.ops.smallblock import fold_repetitions


def subblock_interleave_table(N: int) -> np.ndarray:
    return subblock_jn(N)


@functools.lru_cache(maxsize=None)
def triangle_interleave_table(E: int) -> np.ndarray:
    """iBIL triangular interleaver: out[k] = in[tbl[k]] (38.212 5.4.1.3)."""
    T = math.ceil((-1 + math.sqrt(1 + 8 * E)) / 2)
    V = -np.ones((T, T), np.int64)
    k = 0
    for m in range(T):
        for n in range(T - m):
            if k < E:
                V[m, n] = k
            k += 1
    return np.asarray([V[m, n] for n in range(T) for m in range(T - n)
                       if V[m, n] >= 0], np.int32)


@functools.lru_cache(maxsize=None)
def _ratematch_table(K: int, E: int, N: int, i_bil: int) -> np.ndarray:
    """Composite gather table: fk = dn[tbl] for the whole RM chain."""
    jn = subblock_jn(N)
    if E >= N:
        sel = np.arange(E) % N            # repetition
    elif (K / E) <= 7 / 16:
        sel = np.arange(E) + (N - E)      # puncturing: keep the tail
    else:
        sel = np.arange(E)                # shortening: keep the head
    tbl = jn[sel]
    if i_bil:
        tbl = tbl[triangle_interleave_table(E)]
    return tbl.astype(np.int64)


def polar_ratematch(dn: torch.Tensor, K: int, E: int, i_bil: int
                    ) -> torch.Tensor:
    """(..., N) codeword -> (..., E) rate-matched bits."""
    tbl = _ratematch_table(K, E, dn.shape[-1], i_bil)
    return dn[..., torch.as_tensor(tbl, device=dn.device)]


@functools.lru_cache(maxsize=None)
def _inverse_tables(E: int, N: int):
    jn = subblock_jn(N)
    inv_jn = np.zeros(N, np.int64)
    inv_jn[jn] = np.arange(N)             # LLRout[jn[n]] = outN[n]
    inv_tri = np.zeros(E, np.int64)
    inv_tri[triangle_interleave_table(E)] = np.arange(E)
    return inv_jn, inv_tri


def polar_raterecover(llr: torch.Tensor, K: int, N: int, i_bil: int,
                      llr_limit: float = 20.0,
                      reference_compat: bool = False) -> torch.Tensor:
    """(..., E) LLRs -> (..., N) float32 mother-code LLRs.

    As the JAX package, this fixes one fault of the reference: its
    repetition path (E >= N) skips the iBIL triangle deinterleave;
    reference_compat=True keeps that fault for golden parity."""
    E = llr.shape[-1]
    dev = llr.device
    llr = llr.to(torch.float32)
    inv_jn, inv_tri = _inverse_tables(E, N)
    if i_bil and not (reference_compat and E >= N):
        ine = llr[..., torch.as_tensor(inv_tri, device=dev)]
    else:
        ine = llr
    lead = llr.shape[:-1]
    if E >= N:
        outn = fold_repetitions(ine, N)
    elif (K / E) <= 7 / 16:               # puncturing: LLR 0 at the head
        outn = torch.cat([ine.new_zeros(lead + (N - E,)), ine], -1)
    else:                                 # shortening: +limit at the tail
        outn = torch.cat([ine, ine.new_full(lead + (N - E,), llr_limit)],
                         -1)
    return outn[..., torch.as_tensor(inv_jn, device=dev)]
