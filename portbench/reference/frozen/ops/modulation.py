"""QAM modulation mapper, TS 38.211 5.1.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/ops/modulation.py: bits are reshaped to
(..., n_sym, Qm) and mapped with one vectorized evaluation of the Gray
amplitude recursion amp = 2^(q) - s_1*(2^(q-1) - s_2*(...)), batched over
any leading axes. modulate works on torch tensors, modulate_np on NumPy
arrays (plan-time sequences such as DMRS).
"""
from __future__ import annotations

import math

import numpy as np
import torch

QM_TABLE = {
    "pi/2-bpsk": 1,
    "bpsk": 1,
    "qpsk": 2,
    "16qam": 4,
    "64qam": 6,
    "256qam": 8,
    "1024qam": 10,
}

# modulation order -> the name modulate takes (Qm 1: pi/2-BPSK, the UL's)
QM_NAME = {1: "pi/2-bpsk", 2: "qpsk", 4: "16qam", 6: "64qam", 8: "256qam",
           10: "1024qam"}

_SCALE = {
    1: 1.0 / math.sqrt(2.0),
    2: 1.0 / math.sqrt(2.0),
    4: 1.0 / math.sqrt(10.0),
    6: 1.0 / math.sqrt(42.0),
    8: 1.0 / math.sqrt(170.0),
    10: 1.0 / math.sqrt(682.0),
}


def _gray_amplitude(signs):
    """signs: (..., k) of +-1 -> Gray-mapped odd amplitude (38.211 5.1)."""
    k = signs.shape[-1]
    acc = torch.ones_like(signs[..., 0])
    for j in range(k - 1, 0, -1):
        acc = (2 ** (k - j)) - signs[..., j] * acc
    return signs[..., 0] * acc


def modulate(bits: torch.Tensor, modtype: str) -> torch.Tensor:
    """Map 0/1 bits (..., n_sym*Qm) to complex64 symbols (..., n_sym).

    Matches the reference constellation exactly (incl. pi/2-BPSK's
    alternating rotation on odd symbol indices).
    """
    modtype = modtype.lower()
    qm = QM_TABLE[modtype]
    n = bits.shape[-1]
    if n % qm:
        raise ValueError(f"bit count {n} not a multiple of Qm={qm}")
    b = (1.0 - 2.0 * bits.to(torch.float32)).reshape(
        bits.shape[:-1] + (n // qm, qm))
    scale = _SCALE[qm]
    if modtype in ("bpsk", "pi/2-bpsk"):
        s = b[..., 0]
        re = s
        if modtype == "pi/2-bpsk":
            odd = torch.arange(s.shape[-1], device=s.device) % 2 == 1
            re = torch.where(odd, -s, s)
        return torch.complex(scale * re, scale * s)
    re = _gray_amplitude(b[..., 0::2])
    im = _gray_amplitude(b[..., 1::2])
    return torch.complex(scale * re, scale * im)


def modulate_np(bits, modtype: str) -> np.ndarray:
    return modulate(torch.as_tensor(np.asarray(bits)), modtype).numpy()
