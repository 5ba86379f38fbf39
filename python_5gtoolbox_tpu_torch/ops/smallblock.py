"""Small block codes (32, K <= 11), TS 38.212 5.3.3.

Port of python_5gtoolbox_tpu/ops/smallblock.py: the 1-bit and 2-bit
special tables with the scrambling placeholders x (-1) and y (-2), the
(32, K) Reed-Muller code for 3..11 bits as a GF(2) product, repetition
rate matching, accumulating rate recovery and ML decoding by correlation
against all 2^K codewords. The correlation is a float32 matmul: it must
run in full float32 (TF32 off, PyTorch's default), as the JAX package
runs it at Precision.HIGHEST.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# TS 38.212 Table 5.3.3.1-1 (1 bit) / 5.3.3.2-1 (2 bits) by Qm // 2.
# codes: 0 -> c0, 3 -> c1, 5 -> c2 = (c0 + c1) % 2, -1 -> x, -2 -> y
_ENC_1BIT = [[0], [0, -2], [0, -2, -1, -1], [0, -2, -1, -1, -1, -1],
             [0, -2, -1, -1, -1, -1, -1, -1]]
_ENC_2BIT = [
    [0, 3, 5],
    [0, 3, 5, 0, 3, 5],
    [0, 3, -1, -1, 5, 0, -1, -1, 3, 5, -1, -1],
    [0, 3, -1, -1, -1, -1, 5, 0, -1, -1, -1, -1, 3, 5, -1, -1, -1, -1],
    [0, 3, -1, -1, -1, -1, -1, -1, 5, 0, -1, -1, -1, -1, -1, -1, 3, 5,
     -1, -1, -1, -1, -1, -1],
]

# TS 38.212 Table 5.3.3.3-1 basis sequences M_i,n (32 x 11).
BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    [1, 1, 0, 1, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0],
    [1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0],
    [1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0],
    [1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0],
    [1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
], dtype=np.int8)


def encode_smallblock_np(inbits: np.ndarray, qm: int = 2) -> np.ndarray:
    """Single-block encode, reference-compatible (with the -1/-2 codes):
    encode_smallblock of one (K,) block on the host."""
    assert qm in (1, 2, 4, 6, 8)
    return encode_smallblock(torch.as_tensor(np.asarray(inbits, np.int8)),
                             qm).numpy()


def encode_smallblock(bits: torch.Tensor, qm: int = 2) -> torch.Tensor:
    """Batched encode: (..., K) -> (..., 32) int8 for K >= 3 (the
    Reed-Muller code as a product mod 2); for K 1 and 2 the special table
    of the modulation order qm with its x / y placeholders, (..., its
    length)."""
    k = bits.shape[-1]
    assert 1 <= k < 12
    if k <= 2:
        b = bits.to(torch.int8)
        table = torch.as_tensor((_ENC_1BIT if k == 1 else _ENC_2BIT)[qm // 2],
                                dtype=torch.int8, device=bits.device)
        out = table.expand(bits.shape[:-1] + table.shape)
        for code, col in ((0, b[..., :1]), (3, b[..., 1:]),
                          (5, b[..., :1] ^ b[..., 1:])):
            if col.shape[-1]:
                out = torch.where(table == code, col, out)
        return out
    m = torch.as_tensor(BASIS[:, :k].T, dtype=torch.float32,
                        device=bits.device)
    return torch.remainder(bits.to(torch.float32) @ m, 2.0).to(torch.int8)


def ratematch_smallblock(dn: torch.Tensor, E: int) -> torch.Tensor:
    """(..., N) -> (..., E) by repetition (38.212 5.4.3)."""
    idx = torch.arange(E, device=dn.device) % dn.shape[-1]
    return dn[..., idx]


def fold_repetitions(x: torch.Tensor, N: int) -> torch.Tensor:
    """(..., E) -> (..., N): the sum of the ceil(E/N) repetitions (zero
    padded), added one after the other, which is the order the JAX
    package's XLA reduction takes at the repetition counts of UCI."""
    E = x.shape[-1]
    pad = (-E) % N
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)
    reps = x.reshape(x.shape[:-1] + (-1, N))
    acc = reps[..., 0, :]
    for r in range(1, reps.shape[-2]):
        acc = acc + reps[..., r, :]
    return acc


def raterecover_smallblock(llr: torch.Tensor, N: int) -> torch.Tensor:
    """(..., E) LLRs -> (..., N) float32: repeated transmissions added."""
    return fold_repetitions(llr.to(torch.float32), N)


@functools.lru_cache(maxsize=None)
def _codebook(k: int) -> np.ndarray:
    """(2^k, 32) +-1 codebook for the ML correlation (bit 0 -> +1)."""
    msgs = ((np.arange(2 ** k)[:, None] >> np.arange(k)) & 1).astype(np.int8)
    cw = (msgs.astype(np.int64) @ BASIS[:, :k].T.astype(np.int64)) % 2
    return (1 - 2 * cw).astype(np.float32)


@functools.lru_cache(maxsize=None)
def special_codebook(k: int, qm: int) -> np.ndarray:
    """(2^k, N) float32 codebook of the 1- and 2-bit tables for the ML
    correlation (bit 0 -> +1); the placeholder positions (x = -1,
    y = -2) contribute 0."""
    msgs = ((np.arange(2 ** k)[:, None] >> np.arange(k)) & 1).astype(np.int8)
    rows = []
    for m in msgs:
        cw = encode_smallblock_np(m, qm).astype(np.float32)
        sig = 1.0 - 2.0 * cw
        sig[cw < 0] = 0.0
        rows.append(sig)
    return np.stack(rows)


def decode_smallblock(llr: torch.Tensor, k: int) -> torch.Tensor:
    """ML decode (..., 32) LLRs -> (..., k) int8 bits (K >= 3). LLR
    convention: positive -> bit 0; ties go to the first codeword."""
    cb = torch.as_tensor(_codebook(k), device=llr.device)
    best = torch.argmax(llr.to(torch.float32) @ cb.T, dim=-1)
    return ((best[..., None] >> torch.arange(k, device=llr.device)) & 1
            ).to(torch.int8)
