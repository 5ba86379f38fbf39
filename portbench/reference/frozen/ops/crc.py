"""CRC encode/check for 5G NR (TS 38.212 5.1) as GF(2) matmuls.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/crc.py. The CRC of a length-A message
is a chunked GF(2) matrix product, crc(b) = sum_i b_i (x^(A-1-i+L) mod g)
mod 2: a shared (C, L) remainder matmul per chunk of C bits, then a
per-chunk (L, L) advance. Both are float32 matmuls of 0/1 values whose
sums stay far below 2^24, so they are exact as long as the matmul runs in
full float32: callers on the card keep TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).
cuBLAS has no integer GEMM, which is why the matmuls are float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.frozen.utils.gf2 import gf2_matmul

# g(x) coefficients below the leading x^L term, MSB first (x^(L-1) ... x^0).
# TS 38.212 section 5.1.
CRC_POLYS: dict[str, np.ndarray] = {
    "6": np.array([1, 0, 0, 0, 0, 1], dtype=np.uint8),
    "11": np.array([1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1], dtype=np.uint8),
    "16": np.array([0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
                   dtype=np.uint8),
    "24A": np.array(
        [1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1],
        dtype=np.uint8),
    "24B": np.array(
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1],
        dtype=np.uint8),
    "24C": np.array(
        [1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1],
        dtype=np.uint8),
}

_CHUNK = 512


def crc_len(poly: str) -> int:
    return CRC_POLYS[poly.upper()].size


def _mul_x_mod_g(r: np.ndarray, g: np.ndarray) -> np.ndarray:
    """(x * r(x)) mod g(x). r is an L-vector of coefficients, MSB first."""
    shifted = np.concatenate([r[1:], [0]]).astype(np.uint8)
    if r[0]:
        shifted ^= g
    return shifted


@functools.lru_cache(maxsize=None)
def _remainder_matrix(length: int, poly: str) -> np.ndarray:
    """(length, L) matrix R with R[i] = x^(length-1-i+L) mod g, MSB first;
    crc(b) = (b @ R) mod 2. Built by GF(2) doubling."""
    g = CRC_POLYS[poly.upper()]
    L = g.size
    m0 = min(length, max(L, 8))
    rows = [g.copy()]
    for _ in range(m0 - 1):
        rows.append(_mul_x_mod_g(rows[-1], g))
    R = np.array(rows[::-1], dtype=np.uint8)
    m = m0
    while m < length:
        M = R[:L]
        R = np.vstack([gf2_matmul(R, M).astype(np.uint8), R])
        m *= 2
    return R[R.shape[0] - length:]


@functools.lru_cache(maxsize=None)
def _chunked_tables(length: int, poly: str, chunk: int):
    """(pad, Rc (chunk, L), M (N, L, L)) for the chunked CRC."""
    L = crc_len(poly)
    n_chunks = -(-length // chunk)
    pad = n_chunks * chunk - length
    Rc = _remainder_matrix(chunk, poly)
    Mc = Rc[:L]
    mats = np.zeros((n_chunks, L, L), dtype=np.uint8)
    acc = np.eye(L, dtype=np.uint8)
    for k in range(n_chunks):
        mats[n_chunks - 1 - k] = acc
        acc = gf2_matmul(acc, Mc).astype(np.uint8)
    return pad, Rc, mats


@functools.lru_cache(maxsize=64)
def _device_tables(A: int, poly: str, device: torch.device):
    """The float32 remainder matrix (A, L) below _CHUNK bits, else (pad,
    Rc, M) of the chunked CRC, on the device once per length."""
    f32 = dict(dtype=torch.float32, device=device)
    if A < _CHUNK:
        return (torch.as_tensor(_remainder_matrix(A, poly), **f32),)
    pad, Rc, mats = _chunked_tables(A, poly, _CHUNK)
    return pad, torch.as_tensor(Rc, **f32), torch.as_tensor(mats, **f32)


def _mask_bits(mask, L: int, device=None) -> torch.Tensor:
    """Reference masking: 24-bit MSB-first expansion of mask, keep the L
    LSBs. mask: an int -> (L,), or an int tensor (...) -> (..., L)."""
    shifts = torch.arange(L - 1, -1, -1, device=device)
    if isinstance(mask, (int, np.integer)):
        return ((int(mask) >> shifts) & 1).to(torch.int8)
    mask = torch.as_tensor(mask, device=device).to(torch.int64)
    return ((mask[..., None] >> shifts) & 1).to(torch.int8)


def crc_compute(bits: torch.Tensor, poly: str, mask=0) -> torch.Tensor:
    """CRC parity of `bits` (..., A) 0/1 -> (..., L) int8, batched.

    mask: an int, or an int tensor of the leading shape (one RNTI per
    message, e.g. per PDCCH candidate) that broadcasts against (...)."""
    A = bits.shape[-1]
    L = crc_len(poly)
    dev = bits.device
    x = bits.to(torch.float32)
    if A < _CHUNK:
        rem = torch.remainder(x @ _device_tables(A, poly, dev)[0], 2.0)
    else:
        pad, Rc, mats = _device_tables(A, poly, dev)
        if pad:
            x = torch.cat([x.new_zeros(x.shape[:-1] + (pad,)), x], dim=-1)
        n = x.shape[-1] // _CHUNK
        x = x.reshape(x.shape[:-1] + (n, _CHUNK))
        partial = torch.remainder(x @ Rc, 2.0)
        rem = torch.remainder(torch.einsum("...nl,nlk->...k", partial,
                                           mats), 2.0)
    rem = rem.to(torch.int8)
    if not isinstance(mask, (int, np.integer)) or mask:
        rem = rem ^ _mask_bits(mask, L, dev)
    return rem


def crc_encode(bits: torch.Tensor, poly: str, mask=0) -> torch.Tensor:
    """Append CRC parity bits: (..., A) -> (..., A+L) int8."""
    rem = crc_compute(bits, poly, mask)
    return torch.cat([bits.to(torch.int8), rem], dim=-1)


def crc_check(blkandcrc: torch.Tensor, poly: str, mask=0) -> torch.Tensor:
    """Return per-message error flag (...,) int8; 0 = CRC pass."""
    L = crc_len(poly)
    rem = crc_compute(blkandcrc[..., :-L], poly, mask)
    neq = rem != blkandcrc[..., -L:].to(torch.int8)
    return neq.any(dim=-1).to(torch.int8)

