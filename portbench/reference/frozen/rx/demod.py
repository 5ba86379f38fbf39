"""Max-log LLR soft demodulation for all NR constellations.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/rx/demod.py. With A the constellation scale
and q = Qm/2 levels per I/Q axis:

    F_q(r) = 4A (k+1) (r - sign(r) k A),  k = clip(floor(|r|/2A), 0, 2^(q-1)-1)
    LLR_0  = F_q(r);  r_{j+1} = 2^(q-1-j) A - |r_j|;  LLR_{j+1} = F_{q-1-j}(r_{j+1})

which reproduces the reference's piecewise tables exactly.
"""
from __future__ import annotations

import math

import torch

_QM = {"pi/2-bpsk": 1, "bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6,
       "256qam": 8, "1024qam": 10}
_SCALE = {1: math.sqrt(2), 2: math.sqrt(2), 4: math.sqrt(10),
          6: math.sqrt(42), 8: math.sqrt(170), 10: math.sqrt(682)}


def _f(r, a, q):
    k = torch.clamp(torch.floor(torch.abs(r) / (2 * a)), 0, 2 ** (q - 1) - 1)
    return 4 * a * (k + 1) * (r - torch.sign(r) * k * a)


def demodulate(symbols: torch.Tensor, modtype: str, noise_var):
    """(..., n) equalized symbols -> (hard (..., n*Qm) int8, llr).

    LLR > 0 => bit 0 (reference convention). noise_var broadcasts with
    symbols.
    """
    modtype = modtype.lower()
    qm = _QM[modtype]
    a = 1.0 / _SCALE[qm]
    r_re = symbols.real.to(torch.float32)
    r_im = symbols.imag.to(torch.float32)
    nv = torch.as_tensor(noise_var, device=symbols.device)
    nv = (nv.real if nv.is_complex() else nv).to(torch.float32)
    nv = torch.broadcast_to(nv, r_re.shape)
    if modtype == "bpsk":
        out = 4 * (r_re + r_im) * a / nv
    elif modtype == "pi/2-bpsk":
        odd = torch.arange(r_re.shape[-1], device=symbols.device) % 2 == 1
        out = torch.where(odd, 4 * (-r_re + r_im) * a / nv,
                          4 * (r_re + r_im) * a / nv)
    else:
        q = qm // 2
        llrs = []
        cur_re, cur_im = r_re, r_im
        for j in range(q):
            llrs.append(_f(cur_re, a, q - j) / nv)
            llrs.append(_f(cur_im, a, q - j) / nv)
            if j < q - 1:
                d = (2 ** (q - 1 - j)) * a
                cur_re = d - torch.abs(cur_re)
                cur_im = d - torch.abs(cur_im)
        out = torch.stack(llrs, dim=-1).reshape(r_re.shape[:-1] + (-1,))
    return (out <= 0).to(torch.int8), out
