"""Per-RE channel equalization: ZF / MMSE (+IRC).

Port of the linear equalizers of python_5gtoolbox_tpu/rx/equalize.py
(reference: py5gphy/channel_equalization/{ZF,MMSE}.py and
nr_channel_eq.py). Every RE is one batch element: (N, Nr, NL) channels,
closed-form batched 2x2 inverses and a 2x2-block Schur inverse for 4x4.
The reference's conditional rank-deficiency fix becomes an unconditional
tiny diagonal load. The ML family is not ported yet.
"""
from __future__ import annotations

import torch

from python_5gtoolbox_tpu_torch.rx.demod import demodulate

_EPS = 1e-6
# the equalizers ported so far (the ML family is not)
LINEAR_EQUALIZERS = ("ZF", "ZF-IRC", "MMSE", "MMSE-IRC")


def _h(m):
    return m.conj().transpose(-1, -2)


def _reg(m):
    """Tiny diagonal load ~ reference's singularity fix (always applied)."""
    n = m.shape[-1]
    scale = m.abs().amax(dim=(-2, -1), keepdim=True)
    return m + (_EPS * scale + 1e-30) * torch.eye(n, dtype=m.dtype,
                                                   device=m.device)


def _inv22(m):
    """Closed-form inverse of (..., 2, 2)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) / det[..., None, None]


def inv_small(m):
    """Batched inverse of (..., n, n) for n <= 4 (adjugate for n = 2,
    blockwise 2x2 Schur for n = 4, n = 3 padded to 4)."""
    n = m.shape[-1]
    if n == 1:
        return 1.0 / m
    if n == 2:
        return _inv22(m)
    if n == 3:
        pad = m.new_zeros(m.shape[:-2] + (4, 4))
        pad[..., :3, :3] = m
        pad[..., 3, 3] = 1.0
        return inv_small(pad)[..., :3, :3]
    if n == 4:
        a, b = m[..., :2, :2], m[..., :2, 2:]
        c, d = m[..., 2:, :2], m[..., 2:, 2:]
        ai = _inv22(a)
        si = _inv22(d - c @ ai @ b)
        ai_b = ai @ b
        c_ai = c @ ai
        tl = ai + ai_b @ si @ c_ai
        tr = -(ai_b @ si)
        bl = -(si @ c_ai)
        return torch.cat([torch.cat([tl, tr], dim=-1),
                          torch.cat([bl, si], dim=-1)], dim=-2)
    return torch.linalg.inv(m)


def zf(y, h, cov, irc: bool):
    """y (N, Nr), h (N, Nr, NL), cov (N, Nr, Nr) -> (s_est, noise_var)."""
    hh = _h(h)
    w2 = inv_small(_reg(hh @ h))
    w = w2 @ hh
    s = torch.einsum("nlr,nr->nl", w, y)
    if irc:
        nv = torch.diagonal(w @ cov @ _h(w), dim1=-2, dim2=-1).real
    else:
        sigma2 = torch.diagonal(cov, dim1=-2, dim2=-1).real.mean(
            dim=-1, keepdim=True)
        nv = sigma2 * torch.diagonal(w2, dim1=-2, dim2=-1).real
    return s, nv


def mmse(y, h, cov, irc: bool):
    """MMSE(-IRC) with the reference's bias compensation."""
    hh = _h(h)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    if irc:
        inv_cov = inv_small(_reg(cov))
        inv_w1 = inv_small(_reg(hh @ inv_cov @ h + eye))
        w = inv_w1 @ hh @ inv_cov
    else:
        sigma2 = torch.diagonal(cov, dim1=-2, dim2=-1).real.mean(
            dim=-1)[..., None, None].to(h.dtype)
        inv_w1 = inv_small(_reg(hh @ h / sigma2 + eye))
        w = inv_w1 @ hh / sigma2
    s_hat = torch.einsum("nlr,nr->nl", w, y)
    comp = 1.0 - torch.diagonal(inv_w1, dim1=-2, dim2=-1)
    return s_hat / comp, (1.0 / comp - 1.0).real


def equalize_and_demod_traced(y, h, cov, modtype: str, algo: str):
    """y (N, Nr), h (N, Nr, NL), cov (N, Nr, Nr) -> llr (N*NL*Qm,) in the
    reference serialization order (per RE: layers x Qm). Linear
    equalizers only."""
    if algo not in LINEAR_EQUALIZERS:
        raise NotImplementedError(f"equalizer {algo!r} is not ported yet")
    fn = zf if algo.startswith("ZF") else mmse
    s, nv = fn(y, h, cov, irc=algo.endswith("IRC"))
    _, llr = demodulate(s.reshape(-1), modtype, nv.reshape(-1))
    return llr
