"""PUSCH transmit chain: UL-SCH coding, DMRS, DFT-s-OFDM, precoding.

Port of python_5gtoolbox_tpu/phy/pusch.py, slot-batched TX of the UL-SCH
only (tx_grid_batch): TB-CRC -> code-block segmentation -> LDPC encode ->
rate match with Ncb = N (no LBRM on UL) -> scramble -> pi/2-BPSK..256QAM
-> layer map -> transform-precoding DFT -> codebook precoder -> grid,
batched over slots and code blocks, with the grid composed from static
slices as for the PDSCH (phy/pdsch.py:_pdsch_compose_grid). The DMRS is
the PRBS sequence (CP-OFDM) or the low-PAPR sequence with group or
sequence hopping (transform precoding).

UCI on PUSCH (Queue A item 2) and the per-slot process() (Queue A item
4) are not ported: configs with UCI are not tx_batch_supported, and
process() raises. Transport blocks come from an explicit numpy
Generator, or are passed in (trblks=) to reproduce another run's draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops.lowpapr import lowpapr_seq
from python_5gtoolbox_tpu_torch.ops.modulation import (QM_NAME, modulate,
                                                      modulate_np)
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy import tbsize as tbs_mod
from python_5gtoolbox_tpu_torch.phy.pdsch import (SlotBatchTx, dlsch_encode,
                                                  get_dmrs_symlist)
from python_5gtoolbox_tpu_torch.utils.numerology import carrier_prb_size


def ulsch_encode_batch(trb: torch.Tensor, tbsize: int, qm: int,
                       rate1024: float, n_layers: int, rv: int,
                       g_ulsch: int) -> torch.Tensor:
    """(..., TBSize) bits -> (..., G_ULSCH) coded bits (38.212 6.2): the
    DL-SCH chain with Ncb = N."""
    return dlsch_encode(trb, tbsize, qm, rate1024, n_layers, rv, None,
                        g_ulsch)


def get_precoding_matrix(n_layers: int, n_ports: int, npmi: int
                         ) -> np.ndarray:
    """Codebook W, 38.211 Tables 6.3.1.5-1/-4 (1-2 ports)."""
    if n_layers == 1 and n_ports == 1:
        return np.array([[1]], np.complex64)
    if n_layers == 1 and n_ports == 2:
        assert npmi <= 5
        t = np.array([[1, 0], [0, 1], [1, 1], [1, -1], [1, 1j], [1, -1j]],
                     np.complex64) / math.sqrt(2)
        return t[npmi].reshape(2, 1)
    if n_layers == 2 and n_ports == 2:
        assert npmi <= 2
        mats = [np.array([[1, 0], [0, 1]]) / math.sqrt(2),
                np.array([[1, 1], [1, -1]]) / 2,
                np.array([[1, 1], [1j, -1j]]) / 2]
        return np.asarray(mats[npmi], np.complex64)
    raise ValueError(f"unsupported codebook: {n_layers} layers, "
                     f"{n_ports} ports")


def pusch_symbol_encode(g_seq: torch.Tensor, scramble_seq: torch.Tensor,
                        precoding: torch.Tensor, qm: int, n_layers: int,
                        n_transprecode: int, msc: int) -> torch.Tensor:
    """Scramble (with the UCI placeholders: x (-1) -> 1, y (-2) -> the
    previous scrambled bit) + modulate + layer map + transform-precoding
    DFT + precode -> (..., ant, n_re)."""
    g = g_seq.to(torch.int32)
    scrambled = g.clamp(min=0).to(torch.int8) ^ scramble_seq
    scrambled = torch.where(g == -1, torch.ones_like(scrambled), scrambled)
    scrambled = torch.where(g == -2, torch.roll(scrambled, 1, dims=-1),
                            scrambled)
    syms = modulate(scrambled, QM_NAME[qm])
    n = syms.shape[-1]
    xi = syms.reshape(syms.shape[:-1] + (n // n_layers, n_layers)
                      ).transpose(-1, -2)
    if n_transprecode:
        per = xi.shape[-1]
        y = xi.reshape(xi.shape[:-1] + (per // msc, msc))
        xi = (torch.fft.fft(y, dim=-1) / math.sqrt(msc)).reshape(xi.shape)
    return torch.einsum("al,...lr->...ar", precoding.to(torch.complex64), xi)


def pusch_dmrs_symlist(ld: int, add_pos: int) -> list[int]:
    """38.211 Table 6.4.1.1.3-3 (type A, pos2, single symbol): the
    PDSCH table."""
    return get_dmrs_symlist(ld, add_pos)


def uci_on(pusch_config: dict) -> bool:
    """True when the config multiplexes HARQ-ACK or CSI onto the PUSCH."""
    cfg = pusch_config
    return bool(cfg["EnableACK"] * cfg["NumACKBits"]
                or cfg["EnableCSI1"] * cfg["NumCSI1Bits"]
                or cfg["EnableCSI2"] * cfg["NumCSI2Bits"])


def _dmrs_seq_no_tp(n_scid, nid, start6, size6, slot, sym) -> np.ndarray:
    cinit = ((((14 * slot + sym + 1) * (2 * nid + 1)) << 17)
             + 2 * nid + n_scid) % (2 ** 31)
    seq = gen_prbs_np(cinit, 2 * size6, offset=2 * start6)
    return modulate_np(seq, "qpsk")


def _dmrs_seq_tp(n_pusch_id, hopping, size, slot, sym) -> np.ndarray:
    fgh, v = 0, 0
    if hopping == "groupHopping":
        seq = gen_prbs_np(n_pusch_id // 30, 8, offset=8 * (slot * 14 + sym))
        fgh = int(np.sum(seq * (2 ** np.arange(8)))) % 30
    elif hopping == "sequenceHopping":
        if size >= 72:
            v = int(gen_prbs_np(n_pusch_id, 1, offset=slot * 14 + sym)[0])
    u = (fgh + n_pusch_id) % 30
    return lowpapr_seq(u, v, 0.0, size)


class NrPUSCH(SlotBatchTx):
    """PUSCH channel object (slot-batched TX; the RX methods live in
    phy/pusch_rx.py).

    rng: numpy Generator for transport blocks (default: seeded with 0);
    device: where the TX tensors live (None -> cuda). The configuration
    is not validated: phy/validate.py is not ported (Queue A item 6), and
    Pdsch does not validate either.
    """

    def __init__(self, carrier_config: dict, pusch_config: dict,
                 rng: np.random.Generator | None = None, device=None):
        self.carrier = carrier_config
        self.cfg = dict(pusch_config)
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(0) if rng is None else rng
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        tbsize, qm, rate = tbs_mod.ulsch_tbsize(self.cfg)
        self.tbsize, self.qm, self.rate1024 = tbsize, qm, rate
        self.tbs_lbrm = None            # no LBRM on UL: Ncb = N
        self.rvidx = -1
        self.trblk = None
        self._cache: dict = {}

    def tx_batch_supported(self) -> bool:
        """UL-SCH only (no UCI, so the 6.2.7 multiplex is the identity)
        and the layout rules of SlotBatchTx."""
        return (self.cfg["EnableULSCH"] == 1 and not uci_on(self.cfg)
                and super().tx_batch_supported())

    def precoding_matrix(self) -> np.ndarray:
        cfg = self.cfg
        return get_precoding_matrix(cfg["num_of_layers"],
                                    cfg["nNrOfAntennaPorts"], cfg["nPMI"])

    def dmrs_seq(self, slot: int, sym: int) -> np.ndarray:
        """r(n) of one DMRS symbol: the PRBS sequence (38.211 6.4.1.1.1.1)
        or, with transform precoding, the low-PAPR one (6.4.1.1.1.2)."""
        cfg, dmrs = self.cfg, self.cfg["DMRS"]
        rb_size = cfg["ResAlloType1"]["RBSize"]
        if cfg["nTransPrecode"]:
            tpe = dmrs["transformPrecodingEnabled"]
            return _dmrs_seq_tp(tpe["nPuschID"],
                                tpe["groupOrSequenceHopping"], rb_size * 6,
                                slot, sym)
        n_scid = dmrs["nSCID"]
        tpd = dmrs["transformPrecodingDisabled"]
        nid = int(tpd["NID0"] if n_scid == 0 else tpd["NID1"])
        return _dmrs_seq_no_tp(n_scid, nid,
                               cfg["ResAlloType1"]["RBStart"] * 6,
                               rb_size * 6, slot, sym)

    def scramble_cinit(self) -> int:
        return self.cfg["rnti"] * (2 ** 15) + self.cfg["nNid"]

    def encode_symbols(self, trb, rvs, prec) -> torch.Tensor:
        cfg = self.cfg
        n_layers = cfg["num_of_layers"]
        g_seq = self.coded_bits(trb, rvs, lambda t, rv, G: ulsch_encode_batch(
            t, self.tbsize, self.qm, self.rate1024, n_layers, rv, G))
        return pusch_symbol_encode(
            g_seq, self.scramble_seq(g_seq.shape[1]), prec, self.qm,
            n_layers, cfg["nTransPrecode"],
            cfg["ResAlloType1"]["RBSize"] * 12)

    def process(self, fd_slot, usage, slot):
        raise NotImplementedError(
            "the per-slot PUSCH TX is not ported (UCI multiplexing: Queue A "
            "item 2; the per-slot path: item 4); use tx_grid_batch")


def _attach_rx_methods():
    """Attach the receive path (phy/pusch_rx.py) to NrPUSCH."""
    from python_5gtoolbox_tpu_torch.phy import pusch_rx

    NrPUSCH.rx_process_batch = pusch_rx.PuschRxMixin.rx_process_batch
    NrPUSCH.rx_batch_prepare = pusch_rx.PuschRxMixin.rx_batch_prepare
    NrPUSCH.RX_process = pusch_rx.PuschRxMixin.RX_process


_attach_rx_methods()
