"""Per-RE channel equalization: ZF / MMSE (+IRC) / ML (+IRC).

Port of python_5gtoolbox_tpu/rx/equalize.py (reference:
py5gphy/channel_equalization/{ZF,MMSE,ML,ML2,MMSE_ML,opt_rank2_ML}.py and
nr_channel_eq.py). Every RE is one batch element: (N, Nr, NL) channels,
closed-form batched 2x2 inverses and a 2x2-block Schur inverse for 4x4;
IRC whitening by the eigendecomposition of the inverse covariance; ML as
one (N, C) distance tensor over the C = q^NL candidate vectors with a
first-minimum argmin. The (N, C, Nr) candidate tensor of ML and of
ML2's plain search is split along the RE axis so that each piece stays
under ML_BYTE_BUDGET bytes (the split does not change any result). ML2's
search on a CUDA tensor is the hand-written kernel csrc/ml2_maxlog.cu
(ml2_maxlog), which keeps the candidates on the chip. The reference's
conditional rank-deficiency fix becomes an unconditional tiny diagonal
load.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import kernels, resolve_device
from python_5gtoolbox_tpu_torch.ops.modulation import QM_TABLE, modulate_np
from python_5gtoolbox_tpu_torch.rx.demod import demodulate
from python_5gtoolbox_tpu_torch.utils import profiling

_EPS = 1e-6
LINEAR_EQUALIZERS = ("ZF", "ZF-IRC", "MMSE", "MMSE-IRC")
ML_EQUALIZERS = ("ML-soft", "ML-hard", "ML-IRC-soft", "ML-IRC-hard",
                 "ML2-soft", "ML2-IRC-soft", "MMSE-ML", "MMSE-ML-IRC",
                 "opt-rank2-ML", "opt-rank2-ML-IRC")
# bytes of one piece of the (N, C, Nr) complex64 candidate tensor
ML_BYTE_BUDGET = 2 ** 29
# what csrc/ml2_maxlog.cu takes: layers, RX antennas, bits per symbol
ML2_KERNEL_LAYERS = (1, 2)
ML2_KERNEL_MAX_NR = 8
ML2_KERNEL_QM = (1, 2, 4, 6, 8)


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


@functools.lru_cache(maxsize=None)
def constellation(modtype: str):
    """(syms (q,) complex64, bits (q, Qm) int8): every symbol, indexed by
    the MSB-first integer of its bits (reference get_mod_list)."""
    qm = QM_TABLE[modtype.lower()]
    m = np.arange(2 ** qm)
    bits = ((m[:, None] >> np.arange(qm - 1, -1, -1)) & 1).astype(np.int8)
    return modulate_np(bits.reshape(-1), modtype), bits


@functools.lru_cache(maxsize=None)
def _opposite_symbol_table(modtype: str) -> np.ndarray:
    """(q, Qm) table: for symbol s and bit m, the index of the closest
    symbol with bit m flipped (reference get_oppisite_syms)."""
    return _build_opp(modtype)


def _build_opp(modtype):
    syms, bits = constellation(modtype)
    q, qm = bits.shape
    out = np.zeros((q, qm), np.int32)
    for i in range(q):
        for m in range(qm):
            cand = np.where(bits[:, m] != bits[i, m])[0]
            out[i, m] = cand[np.argmin(np.abs(syms[cand] - syms[i]))]
    return out


@functools.lru_cache(maxsize=None)
def _candidates(modtype: str, nl: int):
    """(cand_idx (C, NL) int64, cand (C, NL) complex64, cand_bits (C,
    NL*Qm) int8) of the full layer-product constellation."""
    syms, bits = constellation(modtype)
    q = len(syms)
    grids = np.meshgrid(*([np.arange(q)] * nl), indexing="ij")
    cand_idx = np.stack([g.reshape(-1) for g in grids], axis=-1)
    cand_bits = np.concatenate([bits[cand_idx[:, l]] for l in range(nl)],
                               axis=1)
    return cand_idx, syms[cand_idx], cand_bits


def _t(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


def _sigma2(cov):
    return torch.diagonal(cov, dim1=-2, dim2=-1).real.mean(dim=-1)


# matrices per torch.linalg.eigh call on the card: cuSOLVER's batched
# eigensolver refuses (CUSOLVER_STATUS_INVALID_VALUE) the 52,800 4x4
# matrices of a 20-slot batched ML RX at the bench allocation (H100,
# CUDA 12.8); 5,280 pass
EIGH_BATCH = 4096


def _eigh(m):
    """torch.linalg.eigh over the leading axis, EIGH_BATCH at a time on a
    CUDA tensor."""
    if not m.is_cuda or m.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(m)
    parts = [torch.linalg.eigh(m[a: a + EIGH_BATCH])
             for a in range(0, m.shape[0], EIGH_BATCH)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _whiten(y, h, cov):
    """IRC whitening: U with U^H U = inv(cov) (eigh-based, as reference)
    -> (U y, U h)."""
    inv_cov = torch.linalg.inv(_reg(cov))
    evals, evecs = _eigh(inv_cov)
    u = _h(evecs * torch.sqrt(torch.clamp(evals, min=0.0)).to(
        evecs.dtype)[..., None, :])
    return torch.einsum("nij,nj->ni", u, y), u @ h


def _whitened(y, h, cov, irc: bool):
    if not irc:
        return y, h, cov
    y, h = _whiten(y, h, cov)
    eye = torch.eye(h.shape[-2], dtype=h.dtype, device=h.device)
    return y, h, eye.expand(cov.shape)


def _pieces(n: int, n_cand: int, nr: int):
    """RE ranges of at most ML_BYTE_BUDGET bytes of (., C, Nr)
    complex64."""
    step = max(1, min(n, ML_BYTE_BUDGET // max(n_cand * nr * 8, 1)))
    return [(a, min(a + step, n)) for a in range(0, max(n, 1), step)]


def _distances(y, h, cand):
    """(n, C) squared distances |y - h c|^2 of every candidate vector c
    (C, NL), elementwise (the same floats however the REs are split)."""
    hs = h[:, None, :, 0] * cand[None, :, None, 0]
    for l in range(1, h.shape[-1]):
        hs = hs + h[:, None, :, l] * cand[None, :, None, l]
    return ((y[:, None, :] - hs).abs() ** 2).sum(dim=-1)


def _soft_opposite(y, h, sigma2, modtype, s_est, lay_idx, hard, nv):
    """Opposite-symbol max-log LLRs (reference ML.py:101-141): flip each
    bit of each layer to the nearest symbol with that bit flipped."""
    syms, bits = constellation(modtype)
    qm = bits.shape[1]
    syms_t = _t(syms, y)
    opp_idx = _t(_opposite_symbol_table(modtype).astype(np.int64), y)
    llrs = []
    for l in range(h.shape[-1]):
        for m in range(qm):
            s_new = s_est.clone()
            s_new[:, l] = syms_t[opp_idx[:, m][lay_idx[:, l]]]
            resid = y - torch.einsum("nrl,nl->nr", h, s_new)
            d = (resid.abs() ** 2).sum(dim=-1) / sigma2
            bit = hard[:, l * qm + m]
            llrs.append(torch.where(bit == 0, -nv[:, l] + d, nv[:, l] - d))
    return torch.stack(llrs, dim=-1)


def _hard_llr(hard):
    return (1 - 2 * hard).to(torch.float32)


def ml(y, h, cov, modtype: str, irc: bool = False, soft: bool = True):
    """Exact ML over the full layer-product constellation, batched over
    REs -> (s_est (N, NL), noise_var (N, NL), hardbits (N, NL*Qm), llr
    (N, NL*Qm)); LLRs by the reference's opposite-symbol max-log
    estimate. The candidate distances are computed in RE pieces of at
    most ML_BYTE_BUDGET bytes."""
    y, h, cov = _whitened(y, h, cov, irc)
    n, nr, nl = h.shape
    cand_idx, cand, cand_bits = _candidates(modtype, nl)
    cand_t = _t(cand, y)
    best, min_dist = [], []
    for a, b in _pieces(n, len(cand), nr):
        dist = _distances(y[a:b], h[a:b], cand_t)
        bi = torch.argmin(dist, dim=-1)
        best.append(bi)
        min_dist.append(torch.gather(dist, 1, bi[:, None])[:, 0])
    best, min_dist = torch.cat(best), torch.cat(min_dist)
    sigma2 = _sigma2(cov)
    s_est = cand_t[best]
    hard = _t(cand_bits, y)[best]
    nv = (min_dist / sigma2)[:, None].expand(n, nl)
    if not soft:
        return s_est, nv, hard, _hard_llr(hard)
    lay_idx = _t(cand_idx, y)[best]
    return s_est, nv, hard, _soft_opposite(y, h, sigma2, modtype, s_est,
                                           lay_idx, hard, nv)


@functools.lru_cache(maxsize=None)
def _device_tables(modtype: str, nl: int, device: torch.device):
    """(syms (q,) complex64, cand (C, NL) complex64, cand_bits (C,
    NL*Qm) int8) on device, copied there once."""
    syms, _ = constellation(modtype)
    _, cand, cand_bits = _candidates(modtype, nl)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (syms, cand, cand_bits))


def ml2_on_kernel(h: torch.Tensor, modtype: str) -> bool:
    """Whether ml2 searches with csrc/ml2_maxlog.cu: a CUDA tensor with
    NL <= 2, Nr <= 8 and at most 8 bits a symbol. Anything else (a CPU
    tensor, three or more layers) takes ml2_maxlog_plain."""
    _, nr, nl = h.shape
    return (h.is_cuda and nl in ML2_KERNEL_LAYERS
            and nr <= ML2_KERNEL_MAX_NR
            and QM_TABLE[modtype.lower()] in ML2_KERNEL_QM)


def ml2_maxlog_plain(y, h, sigma2, modtype: str, soft: bool = True):
    """Exact max-log ML2 search in plain PyTorch on whitened y (N, Nr), h
    (N, Nr, NL) and sigma2 (N,) -> (best (N,) int64, the first candidate
    of least metric; min_lv (N,); llr (N, NL*Qm), None without soft). The
    metrics lv = |y - h c|^2 / sigma2 of every candidate vector c are
    materialised in RE pieces of at most ML_BYTE_BUDGET bytes; the per-bit
    LLR is the least lv with that bit 1 minus the least with it 0."""
    n, nr, nl = h.shape
    _, cand, cand_bits = _candidates(modtype, nl)
    cand_t = _t(cand, y)
    is1 = _t(cand_bits == 1, y)
    outs = []
    for a, b in _pieces(n, len(cand), nr):
        lv = _distances(y[a:b], h[a:b], cand_t) / sigma2[a:b, None]
        best = torch.argmin(lv, dim=-1)
        min_lv = torch.gather(lv, 1, best[:, None])[:, 0]
        llr = None
        if soft:
            inf = torch.full_like(lv, float("inf"))
            llr = torch.stack(
                [torch.where(is1[:, i], lv, inf).amin(dim=1)
                 - torch.where(is1[:, i], inf, lv).amin(dim=1)
                 for i in range(cand_bits.shape[1])], dim=-1)
        outs.append((best, min_lv, llr))
    best, min_lv, llr = zip(*outs)
    return (torch.cat(best), torch.cat(min_lv),
            torch.cat(llr) if soft else None)


def ml2_maxlog(y, h, sigma2, modtype: str):
    """ml2_maxlog_plain's search (soft) on the card, one launch of the
    hand-written kernel csrc/ml2_maxlog.cu over all N REs: y (N, Nr), h
    (N, Nr, NL) complex64 and sigma2 (N,) float32, contiguous CUDA
    tensors -> (best (N,) int64, min_lv (N,) float32, llr (N, NL*Qm)
    float32). Nothing of the C = q^NL candidates reaches device memory.
    Replaces no TPU kernel (the JAX package's ml2 is plain jnp)."""
    n, nr, nl = h.shape
    qm = QM_TABLE[modtype.lower()]
    dev = y.device
    if dev.type != "cuda" or h.device != dev or sigma2.device != dev:
        raise ValueError("ml2_maxlog: y, h and sigma2 must be on one CUDA "
                         "device")
    if (y.dtype, h.dtype, sigma2.dtype) != (torch.complex64, torch.complex64,
                                            torch.float32):
        raise ValueError("ml2_maxlog: y and h must be complex64, sigma2 "
                         "float32")
    if tuple(y.shape) != (n, nr) or tuple(sigma2.shape) != (n,):
        raise ValueError("ml2_maxlog: y must be (N, Nr) and sigma2 (N,) for "
                         "h (N, Nr, NL)")
    if not (y.is_contiguous() and h.is_contiguous()
            and sigma2.is_contiguous()):
        raise ValueError("ml2_maxlog: y, h and sigma2 must be contiguous")
    if nl not in ML2_KERNEL_LAYERS or not 1 <= nr <= ML2_KERNEL_MAX_NR \
            or qm not in ML2_KERNEL_QM:
        raise ValueError(f"ml2_maxlog: takes NL in {ML2_KERNEL_LAYERS}, Nr "
                         f"1..{ML2_KERNEL_MAX_NR} and Qm in {ML2_KERNEL_QM}, "
                         f"got NL {nl}, Nr {nr}, Qm {qm}")
    syms = _device_tables(modtype, nl, dev)[0]
    best = torch.empty(n, dtype=torch.int64, device=dev)
    min_lv = torch.empty(n, dtype=torch.float32, device=dev)
    llr = torch.empty((n, nl * qm), dtype=torch.float32, device=dev)
    if n == 0:
        return best, min_lv, llr
    fn = kernels.library("ml2_maxlog").ml2_maxlog
    rc = fn(y.data_ptr(), h.data_ptr(), syms.data_ptr(), sigma2.data_ptr(),
            best.data_ptr(), min_lv.data_ptr(), llr.data_ptr(), n, nr, nl,
            qm, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("ml2_maxlog", rc)
    kernels.LAUNCHES["ml2_maxlog"] += 1
    return best, min_lv, llr


def _ml2(y, h, cov, modtype, irc, soft, on_kernel):
    y, h, cov = _whitened(y, h, cov, irc)
    n, nl = h.shape[0], h.shape[-1]
    sigma2 = _sigma2(cov)
    if on_kernel:
        profiling.count("ml2_kernel_res", n)
        best, min_lv, llr = ml2_maxlog(y.contiguous(), h.contiguous(),
                                       sigma2.contiguous(), modtype)
    else:
        profiling.count("ml2_plain_res", n)
        best, min_lv, llr = ml2_maxlog_plain(y, h, sigma2, modtype, soft)
    _, cand_t, bits_t = _device_tables(modtype, nl, y.device)
    hard = bits_t[best]
    if not soft:
        llr = _hard_llr(hard)
    return cand_t[best], min_lv[:, None].expand(n, nl), hard, llr


def ml2(y, h, cov, modtype: str, irc: bool = False, soft: bool = True):
    """Exact max-log ML (reference ML2.py:47-163), batched over REs: the
    per-bit LLR is the minimum metric over every candidate vector with
    that bit 1 minus the minimum with that bit 0. The search after the
    whitening is csrc/ml2_maxlog.cu where ml2_on_kernel says so, else
    ml2_maxlog_plain."""
    return _ml2(y, h, cov, modtype, irc, soft, ml2_on_kernel(h, modtype))


def ml2_plain(y, h, cov, modtype: str, irc: bool = False,
              soft: bool = True):
    """ml2 through ml2_maxlog_plain on any device: the kernel's
    counterpart on the card, and what parallel/tp.py:tp_ml2 splits over
    ranks."""
    return _ml2(y, h, cov, modtype, irc, soft, False)


def _ml_finish(y, h, cov, modtype, s_est, best_lay_idx, soft):
    """Shared tail: noise_var and opposite-symbol max-log LLRs given the
    per-layer winning constellation indices (N, NL)."""
    n, nr, nl = h.shape
    _, bits = constellation(modtype)
    sigma2 = _sigma2(cov)
    resid0 = y - torch.einsum("nrl,nl->nr", h, s_est)
    nv = ((resid0.abs() ** 2).sum(dim=-1) / sigma2)[:, None].expand(n, nl)
    bits_t = _t(bits, y)
    hard = torch.cat([bits_t[best_lay_idx[:, l]] for l in range(nl)],
                     dim=-1)
    if not soft:
        return s_est, nv, hard, _hard_llr(hard)
    return s_est, nv, hard, _soft_opposite(y, h, sigma2, modtype, s_est,
                                           best_lay_idx, hard, nv)


def mmse_ml(y, h, cov, modtype: str, irc: bool = False,
            max_neigh: int = 4, soft: bool = True):
    """MMSE-assisted reduced-set ML (MMSE_ML.py:12-105): MMSE picks the
    max_neigh nearest constellation points per layer (ties: the lower
    index first), ML searches only their product set."""
    s_mmse, _ = mmse(y, h, cov, irc=irc)
    y, h, cov = _whitened(y, h, cov, irc)
    n, nr, nl = h.shape
    syms, _ = constellation(modtype)
    syms_t = _t(syms, y)
    p = min(max_neigh, len(syms))
    d_layer = (syms_t[None, None, :] - s_mmse[..., None]).abs()
    sel = torch.sort(d_layer, dim=-1, stable=True).indices[..., :p]
    grids = np.meshgrid(*([np.arange(p)] * nl), indexing="ij")
    combo = _t(np.stack([g.reshape(-1) for g in grids], axis=-1), y)
    cand_lay_idx = torch.stack([sel[:, l, combo[:, l]] for l in range(nl)],
                               dim=-1)                          # (N, C, NL)
    hs = torch.einsum("nrl,ncl->ncr", h, syms_t[cand_lay_idx])
    dist = ((y[:, None, :] - hs).abs() ** 2).sum(dim=-1)
    best = torch.argmin(dist, dim=-1)
    best_lay_idx = cand_lay_idx[torch.arange(n, device=y.device), best]
    return _ml_finish(y, h, cov, modtype, syms_t[best_lay_idx],
                      best_lay_idx, soft)


def opt_rank2_ml(y, h, cov, modtype: str, irc: bool = False,
                 soft: bool = True):
    """Rank-2-optimized exact ML (opt_rank2_ML.py:9-137): each layer's
    constellation is searched with the other layer's PAM coordinates
    solved in closed form. Full ML for NL != 2."""
    if h.shape[-1] != 2:
        return ml(y, h, cov, modtype, irc=irc, soft=soft)
    y, h, cov = _whitened(y, h, cov, irc)
    syms, _ = constellation(modtype)
    syms_t = _t(syms, y)
    pam = _t(np.unique(syms.real), y)

    yh = torch.einsum("nr,nrl->nl", y.conj(), h)
    a0i, a0q = yh[:, 0].real, yh[:, 0].imag
    a1i, a1q = yh[:, 1].real, yh[:, 1].imag
    hh = torch.einsum("nri,nrj->nij", h.conj(), h)
    a2, a3 = hh[:, 0, 0].real, hh[:, 1, 1].real
    a4i, a4q = hh[:, 0, 1].real, hh[:, 0, 1].imag
    x0, y0 = syms_t.real[None, :], syms_t.imag[None, :]

    def quant(target, a):
        """Nearest PAM level if a > 0, farthest otherwise."""
        d = (pam[None, None, :] - target[..., None]).abs()
        pick = torch.where((a > 0)[:, None], d.argmin(dim=-1),
                           d.argmax(dim=-1))
        return pam[pick]

    def branch(b0i, b0q, b1i, b1q, c_self, c_other, a4q_):
        """Search this layer's constellation, solve the other's."""
        l1 = (c_self[:, None] * (x0 ** 2 + y0 ** 2)
              - 2 * b0i[:, None] * x0 + 2 * b0q[:, None] * y0)
        gx = -b1i[:, None] + a4i[:, None] * x0 + a4q_[:, None] * y0
        cx = quant(-gx / c_other[:, None], c_other)
        l2 = c_other[:, None] * cx * cx + 2 * gx * cx
        gy = b1q[:, None] + a4i[:, None] * y0 - a4q_[:, None] * x0
        cy = quant(-gy / c_other[:, None], c_other)
        l3 = c_other[:, None] * cy * cy + 2 * gy * cy
        tot = l1 + l2 + l3
        best = tot.argmin(dim=-1)[:, None]
        metric = torch.gather(tot, 1, best)[:, 0]
        other = torch.complex(torch.gather(cx, 1, best)[:, 0],
                              torch.gather(cy, 1, best)[:, 0])
        return metric, syms_t[best[:, 0]], other

    # layer 0 searched, layer 1 solved; then the converse, whose
    # cross-term takes the conjugate (-a4q)
    m2, s0_a, s1_a = branch(a0i, a0q, a1i, a1q, a2, a3, a4q)
    m3, s1_b, s0_b = branch(a1i, a1q, a0i, a0q, a3, a2, -a4q)
    use2 = m2 <= m3
    s_est = torch.stack([torch.where(use2, s0_a, s0_b),
                         torch.where(use2, s1_a, s1_b)], dim=-1)
    lay_idx = (syms_t[None, None, :] - s_est[..., None]).abs().argmin(dim=-1)
    return _ml_finish(y, h, cov, modtype, s_est, lay_idx, soft)


def _equalize(y, h, cov, modtype: str, algo: str):
    """-> (s_est (N, NL), noise_var (N, NL), hard (N*NL*Qm,) int8, llr
    (N*NL*Qm,)) for any algo name."""
    if algo in LINEAR_EQUALIZERS:
        fn = zf if algo.startswith("ZF") else mmse
        s, nv = fn(y, h, cov, irc=algo.endswith("IRC"))
        hard, llr = demodulate(s.reshape(-1), modtype, nv.reshape(-1))
        return s, nv, hard, llr
    irc = "IRC" in algo
    if algo in ("ML-soft", "ML-hard", "ML-IRC-soft", "ML-IRC-hard"):
        out = ml(y, h, cov, modtype, irc=irc, soft=not algo.endswith("hard"))
    elif algo in ("ML2-soft", "ML2-IRC-soft"):
        out = ml2(y, h, cov, modtype, irc=irc)
    elif algo in ("MMSE-ML", "MMSE-ML-IRC"):
        out = mmse_ml(y, h, cov, modtype, irc=irc)
    elif algo in ("opt-rank2-ML", "opt-rank2-ML-IRC"):
        out = opt_rank2_ml(y, h, cov, modtype, irc=irc)
    else:
        raise ValueError(f"unknown CEQ algo {algo}")
    s, nv, hard, llr = out
    return s, nv, hard.reshape(-1), llr.reshape(-1)


def equalize_and_demod_traced(y, h, cov, modtype: str, algo: str):
    """y (N, Nr), h (N, Nr, NL), cov (N, Nr, Nr) -> llr (N*NL*Qm,) in the
    reference serialization order (per RE: layers x Qm), for every
    equalizer name of the JAX dispatcher."""
    return _equalize(y, h, cov, modtype, algo)[3]


def channel_equ_and_demod(y, h, cov, modtype: str, ceq_config: dict,
                          device=None):
    """Dispatcher of nr_channel_eq.channel_equ_and_demod, batched over
    REs: y (N, Nr); h (N, Nr, NL); cov (N, Nr, Nr) or (Nr, Nr) ->
    (s_est, noise_var, hardbits (N*NL*Qm,), llr (N*NL*Qm,)) in the
    reference serialization order. Tensors stay on their device; numpy
    inputs go to device (None -> cuda)."""
    dev = y.device if isinstance(y, torch.Tensor) and device is None \
        else resolve_device(device)
    y, h, cov = (torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=dev).to(torch.complex64)
        for v in (y, h, cov))
    if cov.ndim == 2:
        cov = cov.expand((y.shape[0],) + tuple(cov.shape))
    return _equalize(y, h, cov, modtype, ceq_config["algo"])
