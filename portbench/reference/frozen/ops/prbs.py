"""Gold-sequence PRBS generator, TS 38.211 5.2.1.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/prbs.py: the length-31 LFSRs are
advanced with GF(2) jump-ahead matrices, then emitted blockwise through
an output matrix. gen_prbs_np makes a sequence on the host for a known
c_init; gen_prbs takes c_init as a tensor (scalar or batched) and makes
the sequences on its device with two small mod-2 matmuls (the x1 part
does not depend on c_init and is a host constant).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.frozen.utils.gf2 import gf2_matmul, gf2_matpow

_NC = 1600
_BLOCK = 2048

# x1(n+31) = x1(n+3) + x1(n); x2(n+31) = x2(n+3)+x2(n+2)+x2(n+1)+x2(n)
_TAPS_X1 = (0, 3)
_TAPS_X2 = (0, 1, 2, 3)


@functools.lru_cache(maxsize=None)
def _step_matrix(taps) -> np.ndarray:
    """31x31 GF(2) matrix advancing state s_n = (x[n..n+30]) by one step."""
    T = np.zeros((31, 31), dtype=np.uint8)
    for j in range(30):
        T[j, j + 1] = 1
    for t in taps:
        T[30, t] = 1
    return T


@functools.lru_cache(maxsize=None)
def _output_matrix(taps, nbits: int) -> np.ndarray:
    """(nbits, 31) matrix O with bit[j] = O[j] . s_n over GF(2)."""
    O = np.zeros((nbits, 31), dtype=np.uint8)
    n0 = min(nbits, 31)
    O[:n0] = np.eye(31, dtype=np.uint8)[:n0]
    for j in range(31, nbits):
        acc = np.zeros(31, dtype=np.uint8)
        for t in taps:
            acc ^= O[j - 31 + t]
        O[j] = acc
    return O


@functools.lru_cache(maxsize=None)
def _jump(taps, n: int) -> np.ndarray:
    """T^n over GF(2) for the given LFSR."""
    return gf2_matpow(_step_matrix(taps), n)


def _gen_lfsr_np(taps, state: np.ndarray, n: int, offset: int) -> np.ndarray:
    """n sequence bits starting at absolute index offset."""
    s = gf2_matmul(_jump(taps, offset), state) % 2
    out = np.empty(n, dtype=np.int8)
    O = _output_matrix(taps, _BLOCK)
    Tb = _jump(taps, _BLOCK)
    pos = 0
    while pos < n:
        m = min(_BLOCK, n - pos)
        out[pos:pos + m] = (O[:m].astype(np.int64) @ s.astype(np.int64)) % 2
        s = gf2_matmul(Tb, s)
        pos += _BLOCK
    return out


@functools.lru_cache(maxsize=None)
def _x1_seq_np_cached(n: int, offset: int):
    state = np.zeros(31, dtype=np.uint8)
    state[0] = 1
    seq = _gen_lfsr_np(_TAPS_X1, state, n, _NC + offset)
    seq.setflags(write=False)
    return seq


def gen_prbs_np(c_init: int, n: int, offset: int = 0) -> np.ndarray:
    """c(n) for n in [offset, offset+n): the reference's gen_nrPRBS with a
    start offset, as int8 0/1."""
    c_init, n, offset = int(c_init), int(n), int(offset)
    x1 = _x1_seq_np_cached(n, offset)
    x2_state = np.array([(c_init >> i) & 1 for i in range(31)], dtype=np.uint8)
    x2 = _gen_lfsr_np(_TAPS_X2, x2_state, n, _NC + offset)
    return ((x1 + x2) % 2).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _x2_block_tables(n: int, offset: int):
    """Stacked A_i = T2^(1600+offset+B*i) and the x2 output matrix."""
    n_blocks = -(-n // _BLOCK)
    A = np.zeros((n_blocks, 31, 31), dtype=np.uint8)
    acc = _jump(_TAPS_X2, _NC + offset)
    Tb = _jump(_TAPS_X2, _BLOCK)
    for i in range(n_blocks):
        A[i] = acc
        acc = gf2_matmul(acc, Tb).astype(np.uint8)
    return A, _output_matrix(_TAPS_X2, _BLOCK)


def c_init_to_state(c_init: torch.Tensor) -> torch.Tensor:
    """Integer c_init (...,) -> (..., 31) float32 LSB-first x2 state."""
    c = torch.as_tensor(c_init).to(torch.int64)
    shifts = torch.arange(31, device=c.device)
    return ((c[..., None] >> shifts) & 1).to(torch.float32)


def gen_prbs(c_init, n: int, offset: int = 0) -> torch.Tensor:
    """c(n) for n in [offset, offset+n) of every c_init in the tensor
    c_init (scalar or batched (...,)) -> (..., n) int8 0/1 on c_init's
    device. The mod-2 sums stay below 2^11, exact in float32."""
    c = torch.as_tensor(c_init)
    dev = c.device
    A, O = _x2_block_tables(int(n), int(offset))
    s2 = c_init_to_state(c)                                   # (..., 31)
    a = torch.as_tensor(A, dtype=torch.float32, device=dev)
    states = torch.remainder(torch.einsum("bij,...j->...bi", a, s2), 2.0)
    o = torch.as_tensor(O, dtype=torch.float32, device=dev)
    bits = torch.remainder(torch.einsum("oj,...bj->...bo", o, states), 2.0)
    bits = bits.reshape(bits.shape[:-2] + (-1,))[..., :n].to(torch.int8)
    x1 = torch.as_tensor(np.array(_x1_seq_np_cached(int(n), int(offset))),
                         device=dev)
    return torch.bitwise_xor(bits, x1)
