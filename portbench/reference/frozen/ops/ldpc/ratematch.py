"""LDPC rate matching / recovery, TS 38.212 5.4.2.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/ldpc/ratematch.py: the reference's
filler-skipping circular-buffer walk is traced once at plan time into a
static index vector, so matching is a gather plus the Qm column
interleave, and recovery a de-interleave plus an index_add_ of the LLRs
(repeated bits are averaged, untransmitted bits get 0, fillers +max_llr).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from portbench.reference.frozen.ops.ldpc.tables import CBInfo


def get_er_ldpc(G: int, C: int, Qm: int, NL: int) -> list[int]:
    """Per-code-block rate-match lengths (38.212 5.4.2.1)."""
    er = []
    for j in range(C):
        if j <= C - ((G / (NL * Qm)) % C) - 1:
            er.append(NL * Qm * math.floor(G / (NL * Qm * C)))
        else:
            er.append(NL * Qm * math.ceil(G / (NL * Qm * C)))
    return er


def get_k0(Ncb: int, bgn: int, rv: int, Zc: int) -> int:
    """RV starting position (38.212 Table 5.4.2.1-2)."""
    num = {1: {0: 0, 1: 17, 2: 33, 3: 56}, 2: {0: 0, 1: 13, 2: 25, 3: 43}}
    den = 66 if bgn == 1 else 50
    return math.floor(num[bgn][rv] * Ncb / (den * Zc)) * Zc


@functools.lru_cache(maxsize=None)
def ratematch_indices(E: int, Ncb: int, k0: int, filler_start: int,
                      filler_end: int) -> np.ndarray:
    """Static E-length gather indices into the dn circular buffer, skipping
    the filler span [filler_start, filler_end)."""
    n_filler = max(0, min(filler_end, Ncb) - min(filler_start, Ncb))
    usable = Ncb - n_filler
    wraps = E // usable + 2
    ring = (k0 + np.arange(wraps * Ncb)) % Ncb
    keep = ~((ring >= filler_start) & (ring < filler_end))
    idx = ring[keep][:E].astype(np.int64)
    if idx.size != E:
        raise ValueError("rate-match walk selected too few bits")
    return idx


def _interleave(e: torch.Tensor, Qm: int) -> torch.Tensor:
    """(..., E) -> Qm-column interleave (38.212 5.4.2.2)."""
    E = e.shape[-1]
    return e.reshape(e.shape[:-1] + (Qm, E // Qm)).transpose(-1, -2) \
        .reshape(e.shape[:-1] + (E,))


def _deinterleave(f: torch.Tensor, Qm: int) -> torch.Tensor:
    E = f.shape[-1]
    return f.reshape(f.shape[:-1] + (E // Qm, Qm)).transpose(-1, -2) \
        .reshape(f.shape[:-1] + (E,))


def _indices(info: CBInfo, E: int, rv: int, Ncb: int) -> np.ndarray:
    k0 = get_k0(Ncb, info.bgn, rv, info.Zc)
    return ratematch_indices(E, Ncb, k0, info.Kd - 2 * info.Zc,
                             info.K - 2 * info.Zc)


def ldpc_ratematch(dn: torch.Tensor, info: CBInfo, E: int, rv: int, Qm: int,
                   Ncb: int | None = None) -> torch.Tensor:
    """(..., N) codeword -> (..., E) rate-matched bits."""
    Ncb = info.N if Ncb is None else Ncb
    idx = torch.as_tensor(_indices(info, E, rv, Ncb), device=dn.device)
    return _interleave(dn[..., idx], Qm)


def ldpc_raterecover(llr_fe: torch.Tensor, info: CBInfo, rv: int, Qm: int,
                     Ncb: int | None = None,
                     max_llr: float | torch.Tensor | None = None
                     ) -> torch.Tensor:
    """(..., E) LLRs -> (..., N) circular-buffer LLRs.

    Repeated transmissions of a bit are averaged; untransmitted bits get
    LLR 0; filler positions get +max_llr (default 10*max|LLR|).
    """
    Ncb = info.N if Ncb is None else Ncb
    E = llr_fe.shape[-1]
    dev = llr_fe.device
    idx, counts, fmask = _recover_tables(info, E, rv, Ncb, dev)
    ek = _deinterleave(llr_fe, Qm).to(torch.float32)
    acc = ek.new_zeros(llr_fe.shape[:-1] + (info.N,))
    acc.index_add_(-1, idx, ek)
    acc = acc / counts
    if max_llr is None:
        max_llr = 10.0 * llr_fe.abs().max()
    if fmask is not None:
        acc = torch.where(fmask, torch.as_tensor(max_llr, dtype=acc.dtype,
                                                 device=dev), acc)
    return acc


@functools.lru_cache(maxsize=64)
def _recover_tables(info: CBInfo, E: int, rv: int, Ncb: int,
                    device: torch.device):
    """(circular-buffer index (E,), repetition counts (N,), filler mask
    (N,) or None) of a rate recovery, on the device once per shape."""
    idx_np = _indices(info, E, rv, Ncb)
    counts = np.maximum(np.bincount(idx_np, minlength=info.N), 1
                        ).astype(np.float32)
    f0, f1 = info.Kd - 2 * info.Zc, info.K - 2 * info.Zc
    fmask = None
    if f1 > f0:
        fmask = np.zeros(info.N, np.bool_)
        fmask[f0:f1] = True
        fmask = torch.as_tensor(fmask, device=device)
    return (torch.as_tensor(idx_np, device=device),
            torch.as_tensor(counts, device=device), fmask)
