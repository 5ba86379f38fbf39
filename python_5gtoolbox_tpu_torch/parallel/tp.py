"""Tensor parallelism: the ML equalizer's candidate axis over ranks.

Port of python_5gtoolbox_tpu/parallel/tp.py. The exact max-log ML search
(rx/equalize.py:ml2) scores all C = q^NL candidate vectors per RE (65536
for 256QAM with 2 layers). Here each rank of a mesh axis scores C/ntp of
them against the whole RE batch, in RE pieces of at most ML_BYTE_BUDGET
bytes as ml2 does, and the ranks combine:

  * the hard decision: one all_gather of each rank's (minimum, argmin + lo)
    per RE, and the first rank holding the minimum wins, which is ml2's
    first-index argmin tie-break (ranks hold the candidates in order);
  * the LLRs: each bit's minimum over its 1-candidates and over its
    0-candidates, combined with one all_reduce(MIN).

A minimum over a partition of the candidates, then over the partial
minima, is the global minimum, and each candidate's distance is computed
as ml2 computes it, so the results equal ml2's.
"""
from __future__ import annotations

import torch

from python_5gtoolbox_tpu_torch.parallel.mesh import (all_gather_stack,
                                                       all_reduce_min,
                                                       axis_group)
from python_5gtoolbox_tpu_torch.rx import equalize as eq


def tp_ml2(y, h, cov, modtype: str, mesh=None, axis="tp", irc: bool = False,
           soft: bool = True):
    """Candidate-parallel exact max-log ML equalize with ml2's contract:
    y (N, Nr), h (N, Nr, NL), cov (N, Nr, Nr), the same on every rank of
    mesh[axis] (mesh None: every rank) -> (s_est, noise_var, hardbits,
    llr), the same on every rank. C = q^NL must divide by the axis
    size."""
    y, h, cov = eq._whitened(y, h, cov, irc)
    n, nr, nl = h.shape
    _, cand, cand_bits = eq._candidates(modtype, nl)
    _, ntp, r = axis_group(mesh, axis)
    c_total = cand.shape[0]
    if c_total % ntp:
        raise ValueError(f"candidate count {c_total} not divisible by "
                         f"mesh axis '{axis}' of size {ntp}")
    shard = c_total // ntp
    lo = r * shard
    cand_t = eq._t(cand, y)
    bits_t = eq._t(cand_bits, y)
    cand_l = cand_t[lo: lo + shard]
    is1 = eq._t(cand_bits[lo: lo + shard] == 1, y)
    sigma2 = eq._sigma2(cov)
    best, mins, v1, v0 = [], [], [], []
    for a, b in eq._pieces(n, shard, nr):
        lv = eq._distances(y[a:b], h[a:b], cand_l) / sigma2[a:b, None]
        bi = torch.argmin(lv, dim=-1)
        best.append(bi + lo)
        mins.append(torch.gather(lv, 1, bi[:, None])[:, 0])
        if soft:
            inf = torch.full_like(lv, float("inf"))
            v1.append(torch.stack([torch.where(is1[:, i], lv, inf).amin(dim=1)
                                   for i in range(is1.shape[1])], dim=-1))
            v0.append(torch.stack([torch.where(is1[:, i], inf, lv).amin(dim=1)
                                   for i in range(is1.shape[1])], dim=-1))
    minv = all_gather_stack(mesh, torch.cat(mins), axis)     # (ntp, N)
    argg = all_gather_stack(mesh, torch.cat(best), axis)
    dev = torch.argmin(minv, dim=0)                          # first-min rank
    gbest = torch.gather(argg, 0, dev[None])[0]
    min_lv = torch.gather(minv, 0, dev[None])[0]
    hard = bits_t[gbest]
    nv = min_lv[:, None].expand(n, nl)
    if not soft:
        return cand_t[gbest], nv, hard, eq._hard_llr(hard)
    llr = (all_reduce_min(mesh, torch.cat(v1), axis)
           - all_reduce_min(mesh, torch.cat(v0), axis))
    return cand_t[gbest], nv, hard, llr
