"""UCI on PUSCH: UCI coding, rate-match resources and the data/control
multiplex, TS 38.212 6.3.2 / 6.2.7.

Port of python_5gtoolbox_tpu/phy/pusch_uci.py: small-block (<= 11 bits)
or polar (nMax 10, iIL 0, iBIL 1) coding of HARQ-ACK, CSI part 1 and CSI
part 2; the beta-offset Q' computation of 6.3.2.4 with the reserved-ACK
rule; and the 6.2.7 placement walk with the x/y placeholder bits -1/-2.
Host numpy: these are functions of the configuration, run once per slot
or once per receiver plan, and the walk also runs over int64 index tags
to build the receiver's gather maps (phy/pusch_rx.py).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops import polar as polar_ops
from python_5gtoolbox_tpu_torch.ops import smallblock as sb_ops
from python_5gtoolbox_tpu_torch.ops.polar.segment import polar_cb_segment_rows

# the UCI streams multiplexed on a PUSCH, in the order of the multiplex's
# concatenation: name, then the configuration's enable, size and payload
# keys and the rate-match info's coded size
UCI_STREAMS = (("ack", "EnableACK", "NumACKBits", "ACKbits", "Euci_ack"),
               ("csi1", "EnableCSI1", "NumCSI1Bits", "CSI1bits",
                "Euci_CSI1"),
               ("csi2", "EnableCSI2", "NumCSI2Bits", "CSI2bits",
                "Euci_CSI2"))

# 38.213 Table 9.3-1 / 9.3-2 beta offsets.
BETA_HARQ_ACK = [1.0, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625,
                 15.875, 20.0, 31.0, 50.0, 80.0, 126.0]
BETA_CSI = [1.125, 1.25, 1.375, 1.625, 1.75, 2.0, 2.25, 2.5, 2.875, 3.125,
            3.5, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625, 15.875, 20.0]


def _plus_l(nbits: int) -> int:
    if nbits <= 11:
        return nbits
    if nbits >= 360 or nbits > 19:
        return nbits + 11
    return nbits + 6


def _min_uci_capacity(a: int) -> int:
    if a <= 11:
        return a
    if a <= 19:
        return a + 6 + 3
    if a < 1013:
        return a + 11
    return a + (a % 2) + 22


def encode_uci_rows(bits: torch.Tensor, n_bits: int, e_tot: int,
                    qm: int) -> torch.Tensor:
    """38.212 6.3.1.2-6.3.1.6 UCI encoding of every row of bits (S, A)
    at once on their device -> (S, e_tot) int8: small-block code (the
    1- and 2-bit tables with their x / y placeholders, the (32, K)
    Reed-Muller code as a product mod 2) repeated to e_tot, or for
    n_bits > 11 segmentation with CRC, the polar transform and polar
    rate matching (nMax 10, iIL 0, iBIL 1), the blocks concatenated."""
    bits = bits.to(torch.int8)
    if n_bits <= 11:
        return sb_ops.ratematch_smallblock(
            sb_ops.encode_smallblock(bits, qm), e_tot)
    cbs, C, er = polar_cb_segment_rows(bits, e_tot)
    enc = polar_ops.polar_encode(cbs, er, 10, 0)
    out = polar_ops.polar_ratematch(enc, cbs.shape[-1], er, 1).reshape(
        bits.shape[0], C * er)
    if C * er < e_tot:
        out = torch.cat([out, out.new_zeros((out.shape[0], e_tot - C * er))],
                        -1)
    return out


def encode_uci_on_ulsch(uci_bits: np.ndarray, n_bits: int, e_tot: int,
                        qm: int) -> np.ndarray:
    """38.212 6.3.1.2-6.3.1.6 UCI encoding (small-block or polar) of one
    payload on the host: encode_uci_rows of one row."""
    return encode_uci_rows(torch.as_tensor(np.asarray(uci_bits, np.int8))
                           [None], n_bits, e_tot, qm)[0].numpy()


def get_ulsch_rm_info(pusch_config: dict, dmrs_symlist, ulsch_size: int,
                      qm: int, rate1024: float, g_total: int) -> dict:
    """Rate-match resource split, 38.212 6.3.2.4 (mirrors getULSCH_RM_info)."""
    cfg = pusch_config
    alpha = cfg["UCIScaling"]
    o_ack = cfg["EnableACK"] * cfg["NumACKBits"]
    o_csi1 = cfg["EnableCSI1"] * cfg["NumCSI1Bits"]
    o_csi2 = cfg["EnableCSI2"] * cfg["NumCSI2Bits"]
    rb = cfg["ResAlloType1"]["RBSize"]
    ssi = cfg["StartSymbolIndex"]
    nsym = cfg["NrOfSymbols"]
    nl = cfg["num_of_layers"]
    en_ulsch = cfg["EnableULSCH"]

    n_non_dmrs = nsym - len(dmrs_symlist)
    total_muci = n_non_dmrs * rb * 12
    l0 = dmrs_symlist[0] + 1
    n_non_dmrs_till_l0 = l0 - ssi - 1
    sum_muci_from_l0 = (n_non_dmrs - n_non_dmrs_till_l0) * rb * 12

    def qbar_ack_for(o, with_l=True):
        nb = _plus_l(o) if with_l else o
        beta = BETA_HARQ_ACK[cfg["I_HARQ_ACK_offset"]]
        if en_ulsch == 1:
            d1 = math.ceil(nb * beta * total_muci / ulsch_size)
            return min(d1, math.ceil(alpha * sum_muci_from_l0))
        return min(math.ceil(nb * beta / (qm * rate1024 / 1024)),
                   math.ceil(alpha * sum_muci_from_l0))

    qbar_ack = qbar_ack_for(o_ack) if o_ack else 0
    if o_ack <= 2:
        qbar_ackrvd = qbar_ack_for(2)
    else:
        qbar_ackrvd = 0

    if o_csi1 == 0:
        qbar_csi1 = 0
    else:
        nb = _plus_l(o_csi1)
        beta = BETA_CSI[cfg["I_CSI1offset"]]
        qbar_ackcsi1 = qbar_ack if cfg["NumACKBits"] > 2 else qbar_ackrvd
        if en_ulsch == 1:
            d1 = math.ceil(nb * beta * total_muci / ulsch_size)
            qbar_csi1 = min(d1, math.ceil(alpha * total_muci) - qbar_ackcsi1)
        else:
            if o_csi2 > 0:
                qbar_csi1 = min(
                    math.ceil(nb * beta / (qm * rate1024 / 1024)),
                    total_muci - qbar_ackcsi1)
            else:
                qbar_csi1 = total_muci - qbar_ackcsi1

    if cfg["NumCSI2Bits"] == 0:
        qbar_csi2 = 0
    else:
        nb = _plus_l(cfg["NumCSI2Bits"])
        beta = BETA_CSI[cfg["I_CSI2offset"]]
        qbar_ackcsi2 = qbar_ack if cfg["NumACKBits"] > 2 else 0
        if en_ulsch == 1:
            d1 = math.ceil(nb * beta * total_muci / ulsch_size)
            qbar_csi2 = min(d1, math.ceil(alpha * total_muci)
                            - qbar_ackcsi2 - qbar_csi1)
        else:
            qbar_csi2 = total_muci - qbar_ackcsi2 - qbar_csi1

    e_ack = nl * qbar_ack * qm
    e_ackrvd = nl * qbar_ackrvd * qm
    e_csi1 = nl * qbar_csi1 * qm
    e_csi2 = nl * qbar_csi2 * qm
    assert g_total >= e_csi1 + e_csi2
    if en_ulsch == 1:
        if cfg["NumACKBits"] > 2:
            g_ulsch = g_total - e_csi1 - e_csi2 - e_ack
        else:
            g_ulsch = g_total - e_csi1 - e_csi2
    else:
        g_ulsch = 0
    assert e_csi1 <= 8192 and e_csi2 <= 8192 and e_ack <= 8192
    assert e_ack >= _min_uci_capacity(o_ack)
    assert e_csi1 >= _min_uci_capacity(o_csi1)
    assert e_csi2 >= _min_uci_capacity(o_csi2)
    return dict(Euci_ack=e_ack, Qbar_ACK=qbar_ack, Euci_CSI1=e_csi1,
                Qbar_CSI1=qbar_csi1, Euci_CSI2=e_csi2, Qbar_CSI2=qbar_csi2,
                Euci_ackrvd=e_ackrvd, Qbar_ACKrvd=qbar_ackrvd,
                G_ULSCH=g_ulsch)


def data_control_multiplex(g_ulsch, g_ack, g_csi1, g_csi2, pusch_config,
                           g_total, dmrs_symlist, rm_info, qm,
                           dtype=np.int8, ack_overwrite=True):
    """38.212 6.2.7 placement walk (mirrors the reference's exact
    behavior, including its absolute-vs-relative symbol indexing which
    assumes StartSymbolIndex precedes the first DMRS symbol).

    `dtype`/`ack_overwrite` support the RX inverse (data_control_separate
    in pusch_rx.py): running the same walk over int64 index tags, with
    the <=2-bit-ACK overwrite of reserved positions optionally disabled
    so ULSCH tag positions survive for the gather-map construction.
    """
    cfg = pusch_config
    rb = cfg["ResAlloType1"]["RBSize"]
    ssi = cfg["StartSymbolIndex"]
    nsym = cfg["NrOfSymbols"]
    ncdm = cfg["DMRS"]["NumCDMGroupsWithoutData"]
    data_re_dmrs_sym = 6 if ncdm == 1 else 0
    nl = cfg["num_of_layers"]
    nlqm = nl * qm

    m_ulsch = [rb * data_re_dmrs_sym if (ssi + m) in dmrs_symlist else rb * 12
               for m in range(nsym)]
    m_uci = [0 if (ssi + m) in dmrs_symlist else rb * 12
             for m in range(nsym)]
    phi_ulsch = [list(range(n)) for n in m_ulsch]
    phi_uci = [list(range(n)) for n in m_uci]

    l1 = dmrs_symlist[0] + 1
    l_csi1 = ssi + 1 if ssi in dmrs_symlist else ssi

    g_seq = np.zeros(g_total, dtype)
    gbar = np.zeros((nsym, rb * 12, nlqm), dtype)

    phibar_ulsch = [list(p) for p in phi_ulsch]
    mbar_ulsch = list(m_ulsch)
    phibar_uci = [list(p) for p in phi_uci]
    mbar_uci = list(m_uci)

    en_ack = cfg["EnableACK"] * cfg["NumACKBits"]

    # step 1: reserved ACK positions (<=2 ACK bits)
    phibar_rvd = [[] for _ in range(nsym)]
    if en_ack <= 2:
        g_ackrvd = rm_info["Euci_ackrvd"]
        cnt = 0
        L = l1
        while cnt < g_ackrvd:
            if mbar_uci[L] > 0:
                if g_ackrvd - cnt >= mbar_uci[L] * nlqm:
                    d, n_re = 1, mbar_ulsch[L]
                else:
                    d = mbar_uci[L] * nlqm // (g_ackrvd - cnt)
                    n_re = math.ceil((g_ackrvd - cnt) / nlqm)
                for j in range(n_re):
                    phibar_rvd[L].append(phibar_ulsch[L][j * d])
                    cnt += nlqm
            L += 1
    mbar_rvd = [len(p) for p in phibar_rvd]

    # step 2: >2 ACK bits
    if en_ack > 2:
        cnt = cnt_all = 0
        L = l1
        g_ack_total = rm_info["Euci_ack"]
        while cnt < g_ack_total:
            if mbar_uci[L] > 0:
                if g_ack_total - cnt >= mbar_uci[L] * nlqm:
                    d, n_re = 1, mbar_ulsch[L]
                else:
                    d = mbar_uci[L] * nlqm // (g_ack_total - cnt)
                    n_re = math.ceil((g_ack_total - cnt) / nlqm)
                used = []
                for j in range(n_re):
                    k = phibar_uci[L][j * d]
                    for v in range(nlqm):
                        gbar[L][k][v] = g_ack[cnt_all]
                        cnt_all += 1
                        cnt += 1
                    used.append(k)
                phibar_uci[L] = [m for m in phibar_uci[L] if m not in used]
                phibar_ulsch[L] = [m for m in phibar_ulsch[L]
                                   if m not in used]
                mbar_uci[L] = len(phibar_uci[L])
                mbar_ulsch[L] = len(phibar_ulsch[L])
            L += 1

    # step 3: CSI1 (skips reserved positions), then CSI2
    if cfg["EnableCSI1"] * cfg["NumCSI1Bits"] > 0:
        cnt = cnt_all = 0
        L = l_csi1
        while mbar_uci[L] - mbar_rvd[L] <= 0:
            L += 1
        total = len(g_csi1)
        while cnt < total:
            avail = mbar_uci[L] - mbar_rvd[L]
            if avail > 0:
                if total - cnt >= avail * nlqm:
                    d, n_re = 1, avail
                else:
                    d = avail * nlqm // (total - cnt)
                    n_re = math.ceil((total - cnt) / nlqm)
                pool = [m for m in phibar_uci[L] if m not in phibar_rvd[L]]
                used = []
                for j in range(n_re):
                    k = pool[j * d]
                    for v in range(nlqm):
                        gbar[L][k][v] = g_csi1[cnt_all]
                        cnt_all += 1
                        cnt += 1
                    used.append(k)
                phibar_uci[L] = [m for m in phibar_uci[L] if m not in used]
                phibar_ulsch[L] = [m for m in phibar_ulsch[L]
                                   if m not in used]
                mbar_uci[L] = len(phibar_uci[L])
                mbar_ulsch[L] = len(phibar_ulsch[L])
            L += 1

    if cfg["EnableCSI2"] * cfg["NumCSI2Bits"] > 0:
        cnt = cnt_all = 0
        L = l_csi1
        while mbar_uci[L] <= 0:
            L += 1
        total = len(g_csi2)
        while cnt < total:
            if mbar_uci[L] > 0:
                if total - cnt >= mbar_uci[L] * nlqm:
                    d, n_re = 1, mbar_uci[L]
                else:
                    d = mbar_uci[L] * nlqm // (total - cnt)
                    n_re = math.ceil((total - cnt) / nlqm)
                used = []
                for j in range(n_re):
                    k = phibar_uci[L][j * d]
                    for v in range(nlqm):
                        gbar[L][k][v] = g_csi2[cnt_all]
                        cnt_all += 1
                        cnt += 1
                    used.append(k)
                phibar_uci[L] = [m for m in phibar_uci[L] if m not in used]
                phibar_ulsch[L] = [m for m in phibar_ulsch[L]
                                   if m not in used]
                mbar_uci[L] = len(phibar_uci[L])
                mbar_ulsch[L] = len(phibar_ulsch[L])
            L += 1

    # step 4: ULSCH fills the remaining positions
    if cfg["EnableULSCH"] == 1:
        cnt = 0
        for L in range(nsym):
            for j in range(mbar_ulsch[L]):
                k = phibar_ulsch[L][j]
                for v in range(nlqm):
                    gbar[L][k][v] = g_ulsch[cnt]
                    cnt += 1

    # step 5: 1-2 ACK bits overwrite the reserved positions
    if en_ack in (1, 2) and ack_overwrite:
        cnt = cnt_all = 0
        g_ack_total = rm_info["Euci_ack"]
        L = l1
        while cnt < g_ack_total:
            if mbar_rvd[L] > 0:
                if g_ack_total - cnt >= mbar_rvd[L] * nlqm:
                    d, n_re = 1, mbar_rvd[L]
                else:
                    d = mbar_rvd[L] * nlqm // (g_ack_total - cnt)
                    n_re = math.ceil((g_ack_total - cnt) / nlqm)
                for j in range(n_re):
                    k = phibar_rvd[L][j * d]
                    for v in range(nlqm):
                        gbar[L][k][v] = g_ack[cnt_all]
                        cnt_all += 1
                        cnt += 1
            L += 1

    # step 6: serialize
    t = 0
    for L in range(nsym):
        for j in range(m_ulsch[L]):
            k = phi_ulsch[L][j]
            g_seq[t: t + nlqm] = gbar[L][k]
            t += nlqm
    return g_seq


def stream_sizes(pusch_config: dict, rm_info: dict) -> dict:
    """Coded bits of each stream in the multiplex (0 where it is off)."""
    cfg = pusch_config
    return dict(
        ulsch=rm_info["G_ULSCH"] if cfg["EnableULSCH"] == 1 else 0,
        ack=rm_info["Euci_ack"] if cfg["EnableACK"] * cfg["NumACKBits"]
        else 0,
        csi1=rm_info["Euci_CSI1"] if cfg["EnableCSI1"] * cfg["NumCSI1Bits"]
        else 0,
        csi2=rm_info["Euci_CSI2"] if cfg["EnableCSI2"] * cfg["NumCSI2Bits"]
        else 0)


def multiplex_tags(pusch_config: dict, g_total: int, dmrs_symlist,
                   rm_info: dict, qm: int, ack_overwrite: bool = True
                   ) -> np.ndarray:
    """data_control_multiplex run over int64 index tags: (g_total,) with
    0 where nothing is placed, else 1 + the bit's index in the
    concatenation of the UL-SCH, ACK, CSI1 and CSI2 streams (sizes of
    stream_sizes). The TX multiplex and the RX demultiplex are gathers
    with it. Cached on what the walk reads, so that channel objects of
    one configuration share it; the array is read-only."""
    cfg = pusch_config
    key = (cfg["ResAlloType1"]["RBSize"], cfg["StartSymbolIndex"],
           cfg["NrOfSymbols"], cfg["DMRS"]["NumCDMGroupsWithoutData"],
           cfg["num_of_layers"], cfg["EnableULSCH"],
           cfg["EnableACK"] * cfg["NumACKBits"],
           cfg["EnableCSI1"] * cfg["NumCSI1Bits"],
           cfg["EnableCSI2"] * cfg["NumCSI2Bits"])
    return _multiplex_tags(key, g_total, tuple(dmrs_symlist),
                           tuple(sorted(rm_info.items())), qm, ack_overwrite)


@functools.lru_cache(maxsize=64)
def _multiplex_tags(key, g_total, dmrs_symlist, rm_items, qm,
                    ack_overwrite):
    rb, ssi, nsym, ncdm, nl, en_ulsch, n_ack, n_csi1, n_csi2 = key
    cfg = dict(ResAlloType1=dict(RBSize=rb), StartSymbolIndex=ssi,
               NrOfSymbols=nsym, DMRS=dict(NumCDMGroupsWithoutData=ncdm),
               num_of_layers=nl, EnableULSCH=en_ulsch, EnableACK=1,
               NumACKBits=n_ack, EnableCSI1=1, NumCSI1Bits=n_csi1,
               EnableCSI2=1, NumCSI2Bits=n_csi2)
    rm_info = dict(rm_items)
    tags, lo = [], 1
    for n in stream_sizes(cfg, rm_info).values():
        tags.append(np.arange(lo, lo + n, dtype=np.int64))
        lo += n
    seq = data_control_multiplex(*tags, cfg, g_total, list(dmrs_symlist),
                                 rm_info, qm, dtype=np.int64,
                                 ack_overwrite=ack_overwrite)
    seq.flags.writeable = False
    return seq
