"""Plain UCI on PUSCH for the benchmark's reference, from TS 38.212:

  5.3.1, 5.4.1      polar code construction, encoding and rate matching
                    (nMax 10, I_IL 0, I_BIL 1: the PUSCH's)
  5.3.3.3, 5.4.3    the (32, K) Reed-Muller block code and its repetition
  6.3.1.2-6.3.1.6,  UCI coding: CRC attachment, channel coding, rate
  6.3.2.2-6.3.2.3   matching and concatenation, on the PUSCH
  6.3.2.4           the split of a slot's coded bits between HARQ-ACK,
                    CSI part 1, CSI part 2 and the UL-SCH
  6.2.7             the data and control multiplex, as the positions of
                    each stream in the slot's serialized coded bits

and the receiver's decoders: an ML Reed-Muller decoder (correlation with
all 2^K codewords) and a CRC-aided successive-cancellation list decoder
of list size 8 with the min-sum LLR rules and the hard path metric
(Balatsoukas-Stimming et al., "LLR-based successive cancellation list
decoding of polar codes", eq. 12), both batched over slots.

It covers what the configuration states and checks the rest: HARQ-ACK of
3 to 11 bits, CSI parts of 20 to 359 bits (one code block with CRC11, no
parity-check bits), no frequency hopping, no PT-RS, DMRS symbols without
data (2 CDM groups without data). LLRs: positive means bit 0. Imports
nothing of the port: numpy, torch and the frozen copy's CRC.
"""
from __future__ import annotations

import functools
import math
import pathlib
from fractions import Fraction

import numpy as np
import torch

from portbench.reference.frozen.ops import crc as crc_ops

_DATA = pathlib.Path(__file__).resolve().parent / "data"

# TS 38.213 Table 9.3-1 (HARQ-ACK) and Table 9.3-2 (CSI): beta offsets by
# index
BETA_HARQ_ACK = ("1.000", "2.000", "2.500", "3.125", "4.000", "5.000",
                 "6.250", "8.000", "10.000", "12.625", "15.875", "20.000",
                 "31.000", "50.000", "80.000", "126.000")
BETA_CSI = ("1.125", "1.250", "1.375", "1.625", "1.750", "2.000", "2.250",
            "2.500", "2.875", "3.125", "3.500", "4.000", "5.000", "6.250",
            "8.000", "10.000", "12.625", "15.875", "20.000")

# TS 38.212 Table 5.3.3.3-1: the basis sequences M_{i,n}, i = 0..31 (rows),
# n = 0..10 (columns)
RM_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1], [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1], [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1], [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1], [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1], [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1], [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1], [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1], [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0], [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0], [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1], [1, 1, 0, 1, 0, 0, 0, 0, 0, 1, 1],
    [1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1], [1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0], [1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0], [1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0],
    [1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0], [1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
    dtype=np.int64)

# TS 38.212 Table 5.4.1.1-1: the sub-block interleaver pattern P(i)
SUBBLOCK_P = (0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19, 12, 20,
              13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31)

N_MAX = 10              # nMax on the uplink
LIST_SIZE = 8
SHORTENED_LLR = 20.0    # LLR of a shortened (known 0) bit


def crc_bits(n_bits: int) -> int:
    """L of 6.3.1.2.1: the CRC of a UCI payload of n_bits (0 for the
    small block code)."""
    return 0 if n_bits <= 11 else (6 if n_bits <= 19 else 11)


# ---- 6.3.2.4: the coded bits of each stream ---------------------------------

def rate_match_split(cfg: dict, g_total: int, dmrs_syms: list[int],
                     ulsch_bits: int, qm: int) -> dict:
    """E_ack, E_csi1, E_csi2 and G_ulsch of one slot of g_total coded bits
    (6.3.2.4.1.1-6.3.2.4.1.3, PUSCH with UL-SCH, no hopping, no PT-RS).
    dmrs_syms: the PUSCH's DMRS symbols (slot indices); ulsch_bits: the
    sum of the UL-SCH's code block sizes K_r."""
    o_ack, o_csi1, o_csi2 = (cfg[en] * cfg[nb] for en, nb in (
        ("EnableACK", "NumACKBits"), ("EnableCSI1", "NumCSI1Bits"),
        ("EnableCSI2", "NumCSI2Bits")))
    if cfg["EnableULSCH"] != 1 or 0 < o_ack <= 2:
        raise ValueError("the reference covers UCI with UL-SCH and no "
                         "reserved HARQ-ACK (more than 2 bits or none)")
    start, n_sym = cfg["StartSymbolIndex"], cfg["NrOfSymbols"]
    m_sc = 12 * cfg["ResAlloType1"]["RBSize"]
    m_uci = [0 if l in dmrs_syms else m_sc
             for l in range(start, start + n_sym)]
    l0 = next(l for l in range(dmrs_syms[0] + 1, start + n_sym)
              if l not in dmrs_syms)
    all_re = sum(m_uci)
    from_l0 = sum(m_uci[l0 - start:])
    alpha = Fraction(str(cfg["UCIScaling"]))
    n_lqm = cfg["num_of_layers"] * qm

    def q(o, beta):
        return math.ceil((o + crc_bits(o)) * Fraction(beta) * all_re
                         / ulsch_bits)

    q_ack = min(q(o_ack, BETA_HARQ_ACK[cfg["I_HARQ_ACK_offset"]]),
                math.ceil(alpha * from_l0)) if o_ack else 0
    q_csi1 = min(q(o_csi1, BETA_CSI[cfg["I_CSI1offset"]]),
                 math.ceil(alpha * all_re) - q_ack) if o_csi1 else 0
    q_csi2 = min(q(o_csi2, BETA_CSI[cfg["I_CSI2offset"]]),
                 math.ceil(alpha * all_re) - q_ack - q_csi1) \
        if o_csi2 else 0
    e = dict(ack=n_lqm * q_ack, csi1=n_lqm * q_csi1, csi2=n_lqm * q_csi2)
    return dict(e, ulsch=g_total - sum(e.values()))


# ---- 6.2.7: where each stream lies in the slot's coded bits -----------------

def multiplex_positions(cfg: dict, dmrs_syms: list[int], n_lqm: int,
                        e: dict) -> dict:
    """The 6.2.7 placement (no frequency hopping, no reserved HARQ-ACK, no
    data on the DMRS symbols) -> {stream: int64 positions}: stream bit j
    is bit positions[j] of the slot's serialized coded bits, for the
    streams ack, csi1, csi2 of e (their coded bit counts) and the UL-SCH
    (ulsch) in the rest, in order."""
    if cfg["DMRS"]["NumCDMGroupsWithoutData"] != 2:
        raise ValueError("the reference covers DMRS symbols without data")
    start, n_sym = cfg["StartSymbolIndex"], cfg["NrOfSymbols"]
    m_sc = 12 * cfg["ResAlloType1"]["RBSize"]
    syms = list(range(start, start + n_sym))
    # the resource elements left for UCI in each symbol, and where the
    # symbol's bits start in the serialized sequence
    free = {l: ([] if l in dmrs_syms else list(range(m_sc))) for l in syms}
    first, offset = {}, 0
    for l in syms:
        first[l] = offset
        offset += n_lqm * len(free[l])
    # l(1): the first symbol without DMRS after the first DMRS symbol(s);
    # l_CSI: the first symbol without DMRS
    l1 = next(l for l in syms if l > dmrs_syms[0] and l not in dmrs_syms)
    l_csi = next(l for l in syms if l not in dmrs_syms)
    out = {}
    for name, l in (("ack", l1), ("csi1", l_csi), ("csi2", l_csi)):
        placed, left = [], e[name]
        while left > 0:
            m = len(free[l])
            if m:
                if left >= m * n_lqm:
                    d, n_re = 1, m
                else:
                    d = m * n_lqm // left
                    n_re = -(-left // n_lqm)
                ks = [free[l][j * d] for j in range(n_re)]
                for k in ks:
                    placed += range(first[l] + k * n_lqm,
                                    first[l] + (k + 1) * n_lqm)
                left -= n_re * n_lqm
                taken = set(ks)
                free[l] = [k for k in free[l] if k not in taken]
            l += 1
        out[name] = np.asarray(placed, np.int64)
    used = np.zeros(offset, bool)
    for pos in out.values():
        used[pos] = True
    out["ulsch"] = np.nonzero(~used)[0].astype(np.int64)
    return out


# ---- the (32, K) Reed-Muller code -------------------------------------------

def rm_encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(S, K) payloads, 3 <= K <= 11 -> (S, e) int8: d_i = sum_n a_n
    M_{i,n} mod 2 (5.3.3.3), repeated to e bits (5.4.3)."""
    k = bits.shape[1]
    assert 3 <= k <= 11
    basis = torch.as_tensor(RM_BASIS[:, :k].T, dtype=torch.float32,
                            device=bits.device)
    d = torch.remainder(bits.to(torch.float32) @ basis, 2.0).to(torch.int8)
    return d[:, torch.arange(e, device=bits.device) % 32]


def rm_decode(llr: torch.Tensor, k: int) -> torch.Tensor:
    """ML decode (S, e) LLRs -> (S, k) int8: the repetitions added, then
    the codeword of 2^k with the largest correlation."""
    s, e = llr.shape
    pad = -e % 32
    acc = torch.cat([llr.to(torch.float32), llr.new_zeros((s, pad))], 1) \
        .reshape(s, -1, 32).sum(1)
    msgs = (np.arange(2 ** k)[:, None] >> np.arange(k)) & 1
    words = msgs @ RM_BASIS[:, :k].T % 2
    signs = torch.as_tensor(1.0 - 2.0 * words, dtype=torch.float32,
                            device=llr.device)
    best = torch.argmax(acc @ signs.T, dim=1)
    return torch.as_tensor(msgs, dtype=torch.int8, device=llr.device)[best]


# ---- polar codes ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reliability() -> np.ndarray:
    """Q_0^(Nmax-1), Table 5.3.1.2-1: bit indices, least reliable
    first."""
    with np.load(_DATA / "polar_reliability.npz") as z:
        return z["sequence"].astype(np.int64)


def _subblock_j(n_len: int) -> np.ndarray:
    """J(n) of 5.4.1.1: y_n = d_J(n)."""
    n = np.arange(n_len)
    return (np.asarray(SUBBLOCK_P)[32 * n // n_len] * (n_len // 32)
            + n % (n_len // 32))


@functools.lru_cache(maxsize=None)
def _triangle(e: int) -> np.ndarray:
    """The I_BIL interleaver of 5.4.1.3 as a gather: f = e[table]."""
    t = 0
    while t * (t + 1) // 2 < e:
        t += 1
    v = np.full((t, t), -1, np.int64)
    k = 0
    for i in range(t):
        for j in range(t - i):
            if k < e:
                v[i, j] = k
            k += 1
    return np.asarray([v[i, j] for j in range(t) for i in range(t - j)
                       if v[i, j] >= 0], np.int64)


@functools.lru_cache(maxsize=None)
def polar_plan(k: int, e: int):
    """(N, info positions ascending, the rate matching as a gather d ->
    f of e bits) of a polar code of k bits in e (5.3.1.2, 5.4.1)."""
    if 18 <= k <= 25:
        raise ValueError("the reference has no parity-check bits")
    ce = math.ceil(math.log2(e))
    n1 = ce - 1 if (e <= 9 / 8 * 2 ** (ce - 1) and k / e < 9 / 16) else ce
    n2 = math.ceil(math.log2(8 * k))
    n_len = 2 ** max(min(n1, n2, N_MAX), 5)
    j = _subblock_j(n_len)
    frozen_rm = set()               # Q_F,tmp of 5.4.1.1
    if e < n_len:
        if k / e <= 7 / 16:         # puncturing
            frozen_rm.update(j[: n_len - e].tolist())
            lim = (3 * n_len / 4 - e / 2 if e >= 3 * n_len / 4
                   else 9 * n_len / 16 - e / 4)
            frozen_rm.update(range(math.ceil(lim)))
        else:                       # shortening
            frozen_rm.update(j[e:].tolist())
    seq = [q for q in _reliability() if q < n_len]
    info = [q for q in reversed(seq) if q not in frozen_rm][:k]
    if e >= n_len:
        sel = np.arange(e) % n_len
    elif k / e <= 7 / 16:
        sel = np.arange(e) + n_len - e
    else:
        sel = np.arange(e)
    return n_len, np.sort(np.asarray(info, np.int64)), j[sel][_triangle(e)]


def polar_encode(c: torch.Tensor, e: int) -> torch.Tensor:
    """(S, K) bits (payload and CRC) -> (S, e) int8: u with c at the
    information positions, d = u G_N (G_N the n-fold Kronecker power of
    [[1, 0], [1, 1]]), then sub-block interleaving, bit selection and the
    triangular interleaver."""
    s, k = c.shape
    n_len, info, rm = polar_plan(k, e)
    dev = c.device
    x = torch.zeros((s, n_len), dtype=torch.int8, device=dev)
    x[:, torch.as_tensor(info, device=dev)] = c.to(torch.int8)
    h = 1
    while h < n_len:
        x = x.reshape(s, -1, 2, h)
        x = torch.stack([x[:, :, 0] ^ x[:, :, 1], x[:, :, 1]], 2)
        h *= 2
    return x.reshape(s, n_len)[:, torch.as_tensor(rm, device=dev)]


def polar_llrs(llr: torch.Tensor, k: int) -> torch.Tensor:
    """The rate recovery of polar_encode: (S, e) LLRs -> (S, N) LLRs of
    d: the repetitions of a bit added, a punctured bit 0, a shortened
    one SHORTENED_LLR."""
    s, e = llr.shape
    n_len, _, rm = polar_plan(k, e)
    dev = llr.device
    sent = torch.zeros((e, n_len), dtype=torch.float32, device=dev)
    sent[torch.arange(e, device=dev), torch.as_tensor(rm, device=dev)] = 1.0
    out = llr.to(torch.float32) @ sent
    if e < n_len and k / e > 7 / 16:
        out[:, torch.as_tensor(np.setdiff1d(np.arange(n_len), rm),
                               device=dev)] = SHORTENED_LLR
    return out


def _f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The min-sum check-node rule: sign(a) sign(b) min(|a|, |b|)."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def polar_scl(llr: torch.Tensor, k: int, e: int, crc: str):
    """CRC-aided SCL decode of (S, N) LLRs of d with list size 8 ->
    (c (S, k) int8, ok (S,) bool): the path of least metric among those
    whose CRC passes, else the path of least metric."""
    s, n_len = llr.shape
    _, info, _ = polar_plan(k, e)
    is_info = np.zeros(n_len, bool)
    is_info[info] = True
    dev = llr.device
    big_l = LIST_SIZE
    rows = torch.arange(s, device=dev)[:, None]
    pm = torch.full((s, big_l), math.inf, device=dev)
    pm[:, 0] = 0.0
    u = torch.zeros((s, big_l, n_len), dtype=torch.int8, device=dev)
    ident = torch.arange(big_l, device=dev).expand(s, big_l)

    def leaf(lam: torch.Tensor, i: int) -> torch.Tensor:
        """Decide u_i on every path -> the paths' origins."""
        nonlocal pm, u
        if not is_info[i]:
            pm = pm + torch.relu(-lam)          # u_i = 0, frozen
            return ident
        cand = torch.cat([pm + torch.relu(-lam), pm + torch.relu(lam)], 1)
        pm, sel = torch.sort(cand, dim=1, stable=True)
        pm, sel = pm[:, :big_l], sel[:, :big_l]
        origin = sel % big_l
        u = u[rows, origin]
        u[:, :, i] = (sel >= big_l).to(torch.int8)
        return origin

    def node(a: torch.Tensor, lo: int):
        """a (S, L, n) LLRs of the codeword of u[lo:lo + n] on each path
        -> (its codeword bits (S, L, n) int8, the paths' origins)."""
        n = a.shape[-1]
        if n == 1:
            origin = leaf(a[..., 0], lo)
            return u[:, :, lo:lo + 1], origin
        h = n // 2
        v1, o1 = node(_f(a[..., :h], a[..., h:]), lo)
        a = a[rows, o1]
        v2, o2 = node(a[..., h:] + (1.0 - 2.0 * v1) * a[..., :h], lo + h)
        v1 = v1[rows, o2]
        return torch.cat([v1 ^ v2, v2], -1), o1.gather(1, o2)

    node(llr.to(torch.float32)[:, None, :].expand(s, big_l, n_len), 0)
    c = u[:, :, torch.as_tensor(info, device=dev)]
    passed = crc_ops.crc_check(c, crc) == 0
    ranked = torch.where(passed, pm, torch.full_like(pm, math.inf))
    best = torch.where(passed.any(1), ranked.argmin(1), pm.argmin(1))
    r = torch.arange(s, device=dev)
    return c[r, best], passed[r, best]


# ---- one stream of UCI ------------------------------------------------------

def encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(S, A) payloads -> (S, e) int8 coded bits (6.3.2.2-6.3.2.3)."""
    a = bits.shape[1]
    if a <= 11:
        return rm_encode(bits, e)
    if a >= 360:
        raise ValueError("the reference codes one polar block")
    crc = str(crc_bits(a))
    return polar_encode(crc_ops.crc_encode(bits.to(torch.int8), crc), e)


def decode(llr: torch.Tensor, a: int):
    """(S, e) LLRs of one stream -> (bits (S, a) int8, ok (S,) bool); ok
    is the CRC of a polar block, True for the Reed-Muller code."""
    if a <= 11:
        return rm_decode(llr, a), torch.ones(llr.shape[0], dtype=torch.bool,
                                             device=llr.device)
    k = a + crc_bits(a)
    c, ok = polar_scl(polar_llrs(llr, k), k, llr.shape[1],
                      str(crc_bits(a)))
    return c[:, :a], ok
