"""PUSCH transmit chain: UL-SCH and UCI coding, DMRS, DFT-s-OFDM,
precoding.

Frozen copy of the PyTorch port of python_5gtoolbox_tpu/phy/pusch.py. Two TX paths:

* tx_grid_batch, UL-SCH only, batched over slots: TB-CRC -> code-block
  segmentation -> LDPC encode -> rate match with Ncb = N (no LBRM on UL)
  -> scramble -> pi/2-BPSK..256QAM -> layer map -> transform-precoding DFT
  -> codebook precoder -> grid, with the grid composed from static slices
  as for the PDSCH (phy/pdsch.py:_pdsch_compose_grid);
* process, one slot into a shared grid and RE-usage map, with UCI on
  PUSCH (HARQ-ACK, CSI part 1, CSI part 2; phy/pusch_uci.py): the UL-SCH
  encode of the batched path at one slot, the UCI coded on the host, the
  38.212 6.2.7 multiplex as one gather from a placement walk over index
  tags (cached per layout), then the symbol encode of the batched path,
  which scrambles the x/y placeholders.

The DMRS is the PRBS sequence (CP-OFDM) or the low-PAPR sequence with
group or sequence hopping (transform precoding). Transport blocks come
from the configuration's data_source, from an explicit numpy Generator,
or are passed in (trblks= / trblk=) to reproduce another run's draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.frozen import resolve_device
from portbench.reference.frozen.ops.lowpapr import lowpapr_seq
from portbench.reference.frozen.ops.modulation import (QM_NAME, modulate,
                                                      modulate_np)
from portbench.reference.frozen.ops.prbs import gen_prbs_np
from portbench.reference.frozen.phy import tbsize as tbs_mod
from portbench.reference.frozen.phy.pdsch import SlotBatchTx, dlsch_encode
from portbench.reference.frozen.utils.numerology import carrier_prb_size


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
    is validated first (phy/validate.py:validate_pusch_config, ValueError
    naming the field), as in the JAX package.
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


# The receive path (phy/pusch_rx.py) attaches its methods to NrPUSCH
# when it is imported, whichever of the two modules a caller imports
# first.
from portbench.reference.frozen.phy import pusch_rx  # noqa: E402,F401
