"""PUSCH transmit chain: UL-SCH and UCI coding, DMRS, DFT-s-OFDM,
precoding.

Port of python_5gtoolbox_tpu/phy/pusch.py. Two TX paths:

* tx_grid_batch, UL-SCH only, batched over slots: TB-CRC -> code-block
  segmentation -> LDPC encode -> rate match with Ncb = N (no LBRM on UL)
  -> scramble -> pi/2-BPSK..256QAM -> layer map -> transform-precoding DFT
  -> codebook precoder -> grid, with the grid composed from static slices
  as for the PDSCH (phy/pdsch.py:_pdsch_compose_grid);
* process, one slot into a shared grid and RE-usage map, with UCI on
  PUSCH (HARQ-ACK, CSI part 1, CSI part 2; phy/pusch_uci.py): the UL-SCH
  encode of the batched path at one slot, the coded UCI streams, the
  38.212 6.2.7 multiplex as one gather from a placement walk over index
  tags (cached per layout), then the symbol encode of the batched path,
  which scrambles the x/y placeholders.

UCI payloads: the configuration's payload lists, coded once per object,
or, where a stream's list is empty, a payload drawn per allocated slot
(draw_uci_bits); encode_uci_rows codes every slot's payloads at once on
the device, and each slot's process() multiplexes its own row.

The DMRS is the PRBS sequence (CP-OFDM) or the low-PAPR sequence with
group or sequence hopping (transform precoding). Transport blocks come
from the configuration's data_source, from an explicit numpy Generator,
or are passed in (trblks= / trblk=) to reproduce another run's draws.
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
from python_5gtoolbox_tpu_torch.ops.ldpc.segment import sch_plan
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.phy.pdsch import (SlotBatchTx, dlsch_encode,
                                                  get_dmrs_symlist)
from python_5gtoolbox_tpu_torch.phy.pusch_uci import (
    UCI_STREAMS, encode_uci_on_ulsch, encode_uci_rows, get_ulsch_rm_info,
    multiplex_tags)
from python_5gtoolbox_tpu_torch.phy.validate import validate_pusch_config
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)
from python_5gtoolbox_tpu_torch.utils.profiling import span


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


def uci_drawn(pusch_config: dict) -> list[str]:
    """The UCI streams whose payload is drawn per allocated slot: those
    that are on and whose payload list is empty."""
    cfg = pusch_config
    return [name for name, en, nb, bits, _ in UCI_STREAMS
            if cfg[en] * cfg[nb] and not len(cfg[bits])]


def draw_uci_bits(pusch_config: dict, n_alloc: int, seed: int,
                  device) -> dict:
    """The payloads of the drawn streams (uci_drawn) for n_alloc
    allocated slots -> {name: (n_alloc, n bits) int8} on device, drawn
    ack, then csi1, then csi2 from one torch.Generator on device seeded
    with (2 * seed + 2) mod 2^63, seed the point's: a draw of transport
    blocks from 2 * seed + 1 (portbench/harness.py) is another stream."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed((2 * seed + 2) % 2 ** 63)
    nbits = {name: pusch_config[nb] for name, _, nb, _, _ in UCI_STREAMS}
    return {name: torch.randint(0, 2, (n_alloc, nbits[name]), generator=gen,
                                device=dev, dtype=torch.int8)
            for name in uci_drawn(pusch_config)}


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
        validate_pusch_config(carrier_config, pusch_config)
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
        # the frame's UCI payloads {name: (Sa, n bits) int8}, one row per
        # allocated slot (draw_uci_bits), in place of the payload lists
        self.uci_bits = None
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
        with span("tx.symbols"):
            return pusch_symbol_encode(
                g_seq, self.scramble_seq(g_seq.shape[1]), prec, self.qm,
                n_layers, cfg["nTransPrecode"],
                cfg["ResAlloType1"]["RBSize"] * 12)

    def process(self, fd_slot: torch.Tensor, usage: np.ndarray,
                slot: int, trblk=None, uci=None):
        """One slot into a shared grid, the reference's protocol: fd_slot
        (ant, 14*n_sc) complex64 on self.device, usage the host (ant,
        14*n_sc) int8 RE-usage map (as Pdsch.process). Both are written
        in place and returned; gated slots are left as they are. rv
        cycling and block draws follow tx_grid_batch; trblk (TBSize,)
        replaces the slot's block; uci, the slot's row of
        encode_uci_rows, replaces the UCI coded from the configuration's
        payload lists. The DMRS and the data symbols go in with one
        indexed write each, at REs read from the host map."""
        cfg = self.cfg
        if not self.is_active_slot(slot):
            return fd_slot, usage
        rv = self.getnextrv()
        if trblk is None:
            if self.rvidx == 0 or self.trblk is None:
                self.trblk = self.get_trblk(self.tbsize)
            trblk = self.trblk
        n_layers = cfg["num_of_layers"]
        fd_slot, usage, dmrs_symlist = self._dmrs_process(fd_slot, usage,
                                                          slot)
        usage, n_data_re = self._data_mapping_prepare(usage)
        g_total = self.qm * n_layers * n_data_re
        g_seq = self._ulsch_uci_process(
            torch.as_tensor(trblk, device=self.device).to(torch.int8),
            g_total, rv, dmrs_symlist, uci)
        precoded = pusch_symbol_encode(
            g_seq, self.scramble_seq(g_total),
            torch.as_tensor(self.precoding_matrix(), device=self.device),
            self.qm, n_layers, cfg["nTransPrecode"],
            cfg["ResAlloType1"]["RBSize"] * 12)            # (ant, n_re)
        return self._data_mapping_commit(precoded, fd_slot, usage), usage

    def _ulsch_uci_process(self, trblk: torch.Tensor, g_total: int, rv: int,
                           dmrs_symlist, uci=None) -> torch.Tensor:
        """(TBSize,) block -> (g_total,) int8 multiplexed coded bits (UCI
        placeholders -1 / -2 included); uci the slot's coded UCI streams
        (None: the configuration's payloads, coded once)."""
        cfg = self.cfg
        key = ("uci_mux", g_total, tuple(dmrs_symlist))
        if key not in self._cache:
            self._cache[key] = self._uci_mux_plan(g_total, dmrs_symlist)
        rm, seq, coded = self._cache[key]
        if uci is None:
            if coded is None:
                raise ValueError(
                    f"UCI streams {uci_drawn(cfg)} have no payload list: "
                    f"set uci_bits (draw_uci_bits) and pass each slot's "
                    f"row of encode_uci_rows as uci=")
            uci = coded
        parts = [torch.zeros(1, dtype=torch.int8, device=self.device)]
        if cfg["EnableULSCH"] == 1:
            parts.append(ulsch_encode_batch(
                trblk[None], self.tbsize, self.qm, self.rate1024,
                cfg["num_of_layers"], rv, rm["G_ULSCH"])[0])
        return torch.cat(parts + [uci])[seq]

    def _uci_mux_plan(self, g_total: int, dmrs_symlist):
        """(rm info, seq (g_total,) gather index into [0, g_ulsch, g_ack,
        g_csi1, g_csi2] (pusch_uci.multiplex_tags), the UCI streams coded
        from the payload lists on the device, or None where a stream is
        drawn per slot)."""
        cfg, qm = self.cfg, self.qm
        rm = self.uci_rm_info(g_total, dmrs_symlist)
        seq = multiplex_tags(cfg, g_total, dmrs_symlist, rm, qm)
        coded = None
        if not uci_drawn(cfg):
            coded = torch.as_tensor(np.concatenate([
                encode_uci_on_ulsch(cfg[bits], cfg[nb], rm[e], qm)
                if cfg[en] * cfg[nb] > 0 else np.zeros(0, np.int8)
                for _, en, nb, bits, e in UCI_STREAMS]), device=self.device)
        return rm, torch.tensor(seq, device=self.device), coded

    def uci_payload(self, n_alloc: int) -> dict:
        """The UCI payloads of n_alloc allocated slots -> {name: (n_alloc,
        n bits) int8} on the device for every stream that is on: its rows
        of self.uci_bits, else its payload list in every row."""
        drawn = self.uci_bits or {}
        out = {}
        for name, en, nb, bits, _ in UCI_STREAMS:
            if not self.cfg[en] * self.cfg[nb]:
                continue
            out[name] = torch.as_tensor(drawn[name], device=self.device) \
                if name in drawn else torch.as_tensor(
                    np.asarray(self.cfg[bits], np.int8),
                    device=self.device).expand(n_alloc, -1)
        return out

    def encode_uci_rows(self) -> torch.Tensor:
        """The UCI of every allocated slot of self.uci_bits coded at once
        on the device (span tx.uci_encode) -> (Sa, E_ack + E_csi1 +
        E_csi2) int8, one row per slot in the multiplex's order, for
        process(uci=); the layout is SlotBatchTx's slot-invariant one."""
        cfg = self.cfg
        assert SlotBatchTx.tx_batch_supported(self), \
            "per-slot UCI payloads need a slot-invariant layout"
        n_alloc = next(iter(self.uci_bits.values())).shape[0]
        g_total = self.qm * cfg["num_of_layers"] * self._tx_layout()[1]
        rm = self.uci_rm_info(g_total, self._dmrs_symlist())
        with span("tx.uci_encode"):
            pay = self.uci_payload(n_alloc)
            return torch.cat([encode_uci_rows(pay[name], cfg[nb], rm[e],
                                              self.qm)
                              for name, _, nb, _, e in UCI_STREAMS
                              if name in pay], dim=1)

    def uci_rm_info(self, g_total: int, dmrs_symlist) -> dict:
        """The 38.212 6.3.2.4 rate-match split of a slot's g_total coded
        bits (pusch_uci.get_ulsch_rm_info), with the UL-SCH's C * K bits
        of the code-block segmentation at g_total (0 without UL-SCH)."""
        cfg = self.cfg
        ulsch_size = 0
        if cfg["EnableULSCH"] == 1:
            info = sch_plan(self.tbsize, self.rate1024, g_total, self.qm,
                            cfg["num_of_layers"], None)[3]
            ulsch_size = info.C * info.K
        return get_ulsch_rm_info(cfg, dmrs_symlist, ulsch_size, self.qm,
                                 self.rate1024, g_total)

    def _dmrs_process(self, fd_slot, usage, slot):
        """Write the precoded DMRS of one slot (one indexed write) and
        mark its REs (and, with 2 CDM groups without data, the other
        comb) in the host usage map."""
        cfg, dmrs = self.cfg, self.cfg["DMRS"]
        assert dmrs["DMRSConfigType"] == 1 and dmrs["NrOfDMRSSymbols"] == 1
        assert dmrs["PUSCHMappintType"] == "A"
        assert dmrs["dmrs_TypeA_Position"] == "pos2"
        rb_start = cfg["ResAlloType1"]["RBStart"]
        rb12 = cfg["ResAlloType1"]["RBSize"] * 12
        n_sc = 12 * self.prb_size
        ncdm = dmrs["NumCDMGroupsWithoutData"]
        symlist = self._dmrs_symlist()
        vals = self._dmrs_values(slot)                # (nd, ant, rb12)
        for sym in symlist:
            base = sym * n_sc + rb_start * 12
            for m in range(cfg["num_of_layers"]):
                delta = ((cfg["PortIndexList"][m] - 1000) // 2) % 2
                usage[m:, base + delta: base + rb12: 2] = \
                    RE_USAGE["PUSCH-DMRS"]
                if ncdm == 2:
                    usage[m:, base + 1 - delta: base + rb12: 2] = \
                        RE_USAGE["PUSCH-DMRS-RSV"]
        res = (np.asarray(symlist)[:, None] * n_sc + rb_start * 12
               + np.arange(rb12)).reshape(-1)
        # every antenna of the grid, a 1-port precoder's row broadcast
        # (the JAX package's slice write)
        write_res(fd_slot, np.arange(fd_slot.shape[0])[:, None],
                  res[None, :],
                  vals.transpose(1, 0, 2).reshape(vals.shape[1], -1))
        return fd_slot, usage, symlist

    def _alloc_columns(self) -> np.ndarray:
        """Flat indices of the allocation's REs, symbol by symbol."""
        cfg = self.cfg
        n_sc = 12 * self.prb_size
        rb_start = cfg["ResAlloType1"]["RBStart"]
        rb12 = cfg["ResAlloType1"]["RBSize"] * 12
        syms = np.arange(cfg["StartSymbolIndex"], cfg["StartSymbolIndex"]
                         + cfg["NrOfSymbols"])
        return (syms[:, None] * n_sc + rb_start * 12
                + np.arange(rb12)).reshape(-1)

    def _data_mapping_prepare(self, usage):
        """Mark the allocation's empty REs as PUSCH data -> (usage, the
        number of data REs on the first antenna)."""
        cols = self._alloc_columns()
        seg = usage[:, cols]
        count = int((seg[0] == RE_USAGE["empty"]).sum())
        seg[seg == RE_USAGE["empty"]] = RE_USAGE["PUSCH-DATA"]
        usage[:, cols] = seg
        return usage, count

    def _data_mapping_commit(self, precoded, fd_slot, usage):
        """Write the data symbols in mapping order (symbol by symbol,
        subcarriers ascending) where the first antenna's usage is PUSCH
        data, in one indexed write."""
        cols = self._alloc_columns()
        cols = cols[usage[0, cols] == RE_USAGE["PUSCH-DATA"]]
        fd_slot[:, torch.as_tensor(cols, device=fd_slot.device)] = \
            precoded[:, : cols.size]
        return fd_slot


# The receive path (phy/pusch_rx.py) attaches its methods to NrPUSCH
# when it is imported, whichever of the two modules a caller imports
# first.
from python_5gtoolbox_tpu_torch.phy import pusch_rx  # noqa: E402,F401
