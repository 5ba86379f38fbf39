"""PDSCH transmit chain: DLSCH coding, modulation, DMRS, RE mapping.

Port of python_5gtoolbox_tpu/phy/pdsch.py. Two TX paths:

* tx_grid_batch: TB-CRC -> code-block segmentation -> LDPC encode -> LBRM
  rate match -> scramble -> QAM -> layer map -> precode -> grid, batched
  over slots and code blocks, with the grid composed from static slices;
* process, one slot into a grid shared with the other DL channels (the
  test models): the DMRS around SSB PRBs and the data on the REs the
  usage map leaves free, so G follows the slot; the same encode at that
  G, its symbols written on the device.

Transport blocks come from the configuration's data_source, from an
explicit numpy Generator, or are passed in (trblks= / trblk=) to
reproduce another run's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch import resolve_device
from python_5gtoolbox_tpu_torch.ops import crc as crc_ops
from python_5gtoolbox_tpu_torch.ops import ldpc as ldpc_ops
from python_5gtoolbox_tpu_torch.ops.ldpc.segment import cb_segment
from python_5gtoolbox_tpu_torch.ops.modulation import (QM_NAME, modulate,
                                                      modulate_np)
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy import tbsize as tbs_mod
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)
from python_5gtoolbox_tpu_torch.utils.profiling import span


def dlsch_encode(trblk: torch.Tensor, tbsize: int, qm: int,
                 rate1024: float, n_layers: int, rv: int,
                 tbs_lbrm: int | None, G: int) -> torch.Tensor:
    """(..., TBSize) bits -> (..., G) rate-matched coded bits (38.212 7.2;
    tbs_lbrm None: Ncb = N, the UL-SCH rule of 6.2.5)."""
    tb_poly, _, bgn, info, ncb, er_list = ldpc_ops.sch_plan(
        tbsize, rate1024, G, qm, n_layers, tbs_lbrm)
    cbs = cb_segment(crc_ops.crc_encode(trblk, tb_poly), info)  # (..., C, K)
    lead = cbs.shape[:-2]
    dn = ldpc_ops.ldpc_encode(cbs.reshape(-1, info.K), bgn)
    dn = dn.reshape(lead + (info.C, dn.shape[-1]))       # (..., C, N)
    return torch.cat([
        ldpc_ops.ldpc_ratematch(dn[..., c0:c1, :], info, E, rv, qm, Ncb=ncb)
        .reshape(lead + ((c1 - c0) * E,))
        for c0, c1, E in ldpc_ops.er_groups(er_list)], dim=-1)


def pdsch_symbol_encode(g_seq: torch.Tensor, scramble_seq: torch.Tensor,
                        precoding: torch.Tensor, qm: int,
                        n_layers: int) -> torch.Tensor:
    """Scramble + modulate + layer map + precode -> (..., ant, n_re)."""
    syms = modulate(g_seq.to(torch.int8) ^ scramble_seq, QM_NAME[qm])
    n = syms.shape[-1]
    xi = syms.reshape(syms.shape[:-1] + (n // n_layers, n_layers)
                      ).transpose(-1, -2)
    return torch.einsum("al,...lr->...ar", precoding.to(torch.complex64), xi)


def _pdsch_compose_grid(data_syms: torch.Tensor, dmrs_vals: torch.Tensor,
                        layout) -> torch.Tensor:
    """(S, ant, n_data_re) data REs in the reference mapping order and
    (S, nd, ant, rb12) DMRS vectors -> (S, ant, 14, n_sc) grids."""
    (n_sc, rb_start, rb_size, start_sym, n_sym, dmrs_syms, cdm,
     data_comb) = layout
    s_dim, nant = data_syms.shape[0], data_syms.shape[1]
    rb12, rb6 = rb_size * 12, rb_size * 6
    grid = data_syms.new_zeros((s_dim, nant, 14, n_sc))
    lo = rb_start * 12
    off = 0
    for sym in range(start_sym, start_sym + n_sym):
        if sym in dmrs_syms:
            region = dmrs_vals[:, dmrs_syms.index(sym)]      # (S, ant, rb12)
            if cdm == 1:
                region = region.reshape(s_dim, nant, rb6, 2).clone()
                region[..., data_comb] = data_syms[..., off: off + rb6]
                region = region.reshape(s_dim, nant, rb12)
                off += rb6
        else:
            region = data_syms[..., off: off + rb12]
            off += rb12
        grid[:, :, sym, lo: lo + rb12] = region
    return grid


def pdsch_dmrs_seq(dmrs_cfg: dict, rb_start: int, rb_size: int, slot: int,
                   sym: int, ref_point_prb: int = 0) -> np.ndarray:
    """r(n) for one DMRS symbol (38.211 7.4.1.1.1), type 1: 6 RE/PRB."""
    nid = dmrs_cfg["nNIDnSCID"]
    cinit = ((((14 * slot + sym + 1) * (2 * nid + 1)) << 17)
             + 2 * nid + dmrs_cfg["nSCID"]) % (2 ** 31)
    start = (ref_point_prb + rb_start) * 6
    seq = gen_prbs_np(cinit, 2 * rb_size * 6, offset=2 * start)
    return modulate_np(seq, "qpsk")


def get_dmrs_symlist(ld: int, add_pos: int) -> list[int]:
    """DM-RS symbol positions, 38.211 Table 7.4.1.1.2-3 (type A, l0=2)."""
    if ld <= 7:
        return [2]
    if ld <= 9:
        return [2] if add_pos == 0 else [2, 7]
    if ld <= 11:
        return {0: [2], 1: [2, 9]}.get(add_pos, [2, 6, 9])
    if ld == 12:
        return {0: [2], 1: [2, 9], 2: [2, 6, 9]}.get(add_pos, [2, 5, 8, 11])
    return {0: [2], 1: [2, 11], 2: [2, 7, 11], 3: [2, 5, 8, 11]}[add_pos]


class SlotBatchTx:
    """Slot-batched TX shared by Pdsch and NrPUSCH (phy/pusch.py): HARQ
    rv cycling, transport blocks, the static RE layout, the DMRS vectors
    and tx_grid_batch. A subclass sets cfg, carrier, device, rng,
    prb_size, tbsize, qm, rate1024, rvidx = -1, trblk = None and _cache =
    {}, and gives precoding_matrix(), dmrs_seq(slot, sym), scramble_cinit()
    and encode_symbols(trb, rvs, prec)."""

    def is_active_slot(self, slot: int) -> bool:
        """True when the configuration allocates this slot."""
        return (slot % self.cfg["period_in_slot"]) in \
            self.cfg["allocated_slots"]

    def getnextrv(self) -> int:
        rvlist = self.cfg["rv"]
        self.rvidx = (self.rvidx + 1) % len(rvlist)
        return rvlist[self.rvidx]

    def get_trblk(self, tbsize: int) -> np.ndarray:
        src = list(self.cfg.get("data_source", []))
        if not src:
            return self.rng.integers(0, 2, size=tbsize).astype(np.int8)
        reps = tbsize // len(src) + 1
        return np.asarray((src * reps)[:tbsize], np.int8)

    def _dmrs_symlist(self) -> list[int]:
        cfg = self.cfg
        return get_dmrs_symlist(cfg["StartSymbolIndex"] + cfg["NrOfSymbols"],
                                cfg["DMRS"]["DMRSAddPos"])

    def tx_batch_supported(self) -> bool:
        """True when the RE layout is slot-invariant and structured
        (type-1 single-symbol DMRS inside the allocation, one data comb)."""
        cfg, dmrs = self.cfg, self.cfg["DMRS"]
        if dmrs["DMRSConfigType"] != 1 or dmrs["NrOfDMRSSymbols"] != 1:
            return False
        start = cfg["StartSymbolIndex"]
        ld = start + cfg["NrOfSymbols"]
        if any(s < start or s >= ld for s in self._dmrs_symlist()):
            return False
        combs = {((p - 1000) // 2) % 2
                 for p in cfg["PortIndexList"][:cfg["num_of_layers"]]}
        return not (dmrs["NumCDMGroupsWithoutData"] == 1 and len(combs) != 1)

    def _tx_layout(self):
        cfg, dmrs = self.cfg, self.cfg["DMRS"]
        start = cfg["StartSymbolIndex"]
        n_sym = cfg["NrOfSymbols"]
        dmrs_syms = tuple(self._dmrs_symlist())
        cdm = dmrs["NumCDMGroupsWithoutData"]
        comb = ((cfg["PortIndexList"][0] - 1000) // 2) % 2
        rb_start = cfg["ResAlloType1"]["RBStart"]
        rb_size = cfg["ResAlloType1"]["RBSize"]
        n_data_re = (n_sym - len(dmrs_syms)) * rb_size * 12
        if cdm == 1:
            n_data_re += len(dmrs_syms) * rb_size * 6
        layout = (12 * self.prb_size, rb_start, rb_size, start, n_sym,
                  dmrs_syms, cdm, 1 - comb)
        return layout, n_data_re

    def _dmrs_values(self, slot: int, precoding=None) -> np.ndarray:
        """Precoded DMRS vectors for one slot: (nd, ant, rb12) complex64."""
        if precoding is None:
            precoding = self.precoding_matrix()
        cfg, dmrs = self.cfg, self.cfg["DMRS"]
        rb_size = cfg["ResAlloType1"]["RBSize"]
        ports = cfg["PortIndexList"]
        scaling = (1.0 if dmrs["NumCDMGroupsWithoutData"] == 1
                   else 10 ** (-3 / 20))
        symlist = self._dmrs_symlist()
        out = np.zeros((len(symlist), precoding.shape[0], rb_size * 12),
                       np.complex64)
        for k, sym in enumerate(symlist):
            seq = self.dmrs_seq(slot, sym)
            data = np.zeros((cfg["num_of_layers"], rb_size * 12),
                            np.complex64)
            for m in range(cfg["num_of_layers"]):
                d0 = ports[m] - 1000
                delta = (d0 // 2) % 2
                wf1 = 1 - (d0 % 2) * 2
                data[m, 0 + delta::4] = scaling * seq[0::2]
                data[m, 2 + delta::4] = scaling * wf1 * seq[1::2]
            out[k] = precoding @ data
        return out

    def scramble_seq(self, G: int) -> torch.Tensor:
        """The (G,) int8 data scrambling sequence, cached on the device."""
        key = ("scr", self.scramble_cinit(), G)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(gen_prbs_np(key[1], G),
                                               device=self.device)
        return self._cache[key]

    def tx_grid_batch(self, slot_list, roll_ant: int = 0, trblks=None):
        """Slot-batched TX: every allocated slot of slot_list encoded and
        composed at once -> (S, ant, 14, n_sc) complex64 grids on
        self.device (gated slots all-zero).

        rv cycling and transport-block regeneration follow the per-slot
        process() of the reference (rvidx advances per allocated slot; a
        fresh block at rvidx 0). trblks (Sa, TBSize), one row per
        allocated slot, replaces the drawn blocks. roll_ant=k emits the
        grid with the antenna axis pre-rolled by -k (the reference's
        tx_low_phy ifftshift roll folded into the precoder rows).
        """
        cfg = self.cfg
        dev = self.device
        n_ant = self.carrier["num_of_ant"]
        pm = self.precoding_matrix()
        prec = np.roll(pm, -roll_ant, axis=0) if roll_ant else pm
        layout, _ = self._tx_layout()
        n_sc = layout[0]
        s_dim = len(slot_list)

        active_idx, rvs, drawn = [], [], []
        for i, slot in enumerate(slot_list):
            if not self.is_active_slot(slot):
                continue
            rvs.append(self.getnextrv())
            if trblks is None and (self.rvidx == 0 or self.trblk is None):
                self.trblk = self.get_trblk(self.tbsize)
            active_idx.append(i)
            drawn.append(self.trblk)
        grid = torch.zeros((s_dim, n_ant, 14, n_sc), dtype=torch.complex64,
                           device=dev)
        if not active_idx:
            return grid
        if trblks is None:
            trb = torch.as_tensor(np.stack(drawn), device=dev)
        else:
            trb = torch.as_tensor(trblks, device=dev).to(torch.int8)
            if trb.shape != (len(active_idx), self.tbsize):
                raise ValueError(f"trblks must be ({len(active_idx)}, "
                                 f"{self.tbsize}), got {tuple(trb.shape)}")
        precoded = self.encode_symbols(
            trb, rvs, torch.as_tensor(prec, device=dev))  # (Sa, ant, n_re)
        with span("tx.grid"):
            dmrs_key = ("dmrs", roll_ant) + tuple(
                int(slot_list[i]) for i in active_idx)
            if dmrs_key not in self._cache:
                self._cache[dmrs_key] = torch.as_tensor(np.stack(
                    [self._dmrs_values(int(slot_list[i]), precoding=prec)
                     for i in active_idx]), device=dev)
            composed = _pdsch_compose_grid(precoded, self._cache[dmrs_key],
                                           layout)
            if len(active_idx) == s_dim:
                return composed
            grid[torch.as_tensor(active_idx, device=dev)] = composed
            return grid

    def coded_bits(self, trb: torch.Tensor, rvs, encode) -> torch.Tensor:
        """(Sa, G) int8 coded bits, one encode(trb rows, rv, G) call per
        distinct rv (span tx.sch_encode)."""
        n_layers = self.cfg["num_of_layers"]
        G = self.qm * n_layers * self._tx_layout()[1]
        with span("tx.sch_encode"):
            g_seq = torch.zeros((len(rvs), G), dtype=torch.int8,
                                device=self.device)
            for rv in sorted(set(rvs)):
                idx = torch.as_tensor(
                    [k for k, v in enumerate(rvs) if v == rv],
                    device=self.device)
                g_seq[idx] = encode(trb[idx], rv, G)
        return g_seq


class Pdsch(SlotBatchTx):
    """PDSCH channel object (slot-batched and per-slot TX; the RX methods
    live in phy/pdsch_rx.py).

    rng: numpy Generator for transport blocks (default: seeded with 0);
    device: where the TX tensors live (None -> cuda).
    """

    def __init__(self, pdsch_config: dict, carrier_config: dict,
                 rng: np.random.Generator | None = None, device=None):
        self.cfg = dict(pdsch_config)
        self.carrier = carrier_config
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(0) if rng is None else rng
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        tbsize, qm, rate = tbs_mod.gen_tbsize(self.cfg)
        self.tbsize, self.qm, self.rate1024 = tbsize, qm, rate
        self.tbs_lbrm = tbs_mod.gen_tbs_lbrm(
            self.cfg, self.prb_size, carrier_config["maxMIMO_layers"])
        self.rvidx = -1
        self.trblk = None
        pm = np.asarray(self.cfg.get("precoding_matrix", []),
                        dtype=np.complex64)
        if pm.size == 0:
            pm = np.eye(carrier_config["num_of_ant"],
                        self.cfg["num_of_layers"], dtype=np.complex64)
        self.precoding = pm[:carrier_config["num_of_ant"],
                            :self.cfg["num_of_layers"]]
        self._cache: dict = {}

    def precoding_matrix(self) -> np.ndarray:
        return self.precoding

    def dmrs_seq(self, slot: int, sym: int) -> np.ndarray:
        ra = self.cfg["ResAlloType1"]
        return pdsch_dmrs_seq(self.cfg["DMRS"], ra["RBStart"], ra["RBSize"],
                              slot, sym)

    def scramble_cinit(self) -> int:
        return self.cfg["rnti"] * (2 ** 15) + self.cfg["nID"]

    def encode_symbols(self, trb, rvs, prec) -> torch.Tensor:
        n_layers = self.cfg["num_of_layers"]
        g_seq = self.coded_bits(trb, rvs, lambda t, rv, G: dlsch_encode(
            t, self.tbsize, self.qm, self.rate1024, n_layers, rv,
            self.tbs_lbrm, G))
        with span("tx.symbols"):
            return pdsch_symbol_encode(
                g_seq, self.scramble_seq(g_seq.shape[1]), prec, self.qm,
                n_layers)

    # -- per-slot TX into a shared grid (the multi-channel waveform) --------
    def process(self, fd_slot: torch.Tensor, usage: np.ndarray, slot: int):
        """One slot into a shared grid, the reference's protocol: fd_slot
        (ant, 14*n_sc) complex64 on self.device, usage the host (ant,
        14*n_sc) int8 map of what the slot's earlier channels (SSB,
        CSI-RS, PDCCH) took. Both are written in place and returned;
        gated slots are left as they are. rv cycling and block draws
        follow tx_grid_batch.

        The DMRS goes in with one indexed write (PRBs that carry an SSB
        skipped); the data REs are the allocation's empty REs, so G and
        the rate matching follow the slot. The coded symbols (dlsch_encode
        at this G, then pdsch_symbol_encode) stay on the device and go in
        with one indexed write whose positions come from the usage map.
        """
        if not self.is_active_slot(slot):
            return fd_slot, usage
        rv = self.getnextrv()
        if self.rvidx == 0 or self.trblk is None:
            self.trblk = self.get_trblk(self.tbsize)
        n_layers = self.cfg["num_of_layers"]
        self._dmrs_process(fd_slot, usage, slot)
        n_data_re = self._data_mapping_prepare(usage)
        G = self.qm * n_layers * n_data_re
        dev = self.device
        g_seq = dlsch_encode(
            torch.as_tensor(self.trblk, device=dev)[None],
            self.tbsize, self.qm, self.rate1024, n_layers, rv,
            self.tbs_lbrm, G)[0]
        if "prec" not in self._cache:
            self._cache["prec"] = torch.as_tensor(self.precoding, device=dev)
        precoded = pdsch_symbol_encode(g_seq, self.scramble_seq(G),
                                       self._cache["prec"], self.qm,
                                       n_layers)              # (ant, n_re)
        fd_slot[:, torch.as_tensor(self._data_columns(usage), device=dev)] \
            = precoded
        return fd_slot, usage

    def _dmrs_process(self, fd_slot, usage, slot):
        """Write the precoded DMRS of one slot (one indexed write) and
        mark its REs in usage; PRBs whose first antenna's usage holds an
        SSB RE are skipped. Raises AssertionError where the DMRS would
        take a CSI-RS RE."""
        cfg, dmrs = self.cfg, self.cfg["DMRS"]
        assert dmrs["DMRSConfigType"] == 1 and dmrs["NrOfDMRSSymbols"] == 1
        rb_start = cfg["ResAlloType1"]["RBStart"]
        rb_size = cfg["ResAlloType1"]["RBSize"]
        n_layers = cfg["num_of_layers"]
        ports = cfg["PortIndexList"]
        n_sc = 12 * self.prb_size

        # per-PRB usage template
        re_map_prb = np.zeros((n_layers, 12), np.int8)
        if dmrs["NumCDMGroupsWithoutData"] == 2:
            re_map_prb[:, :] = RE_USAGE["PDSCH-DMRS-RSV"]
        for m in range(n_layers):
            d0 = ports[m] - 1000
            re_map_prb[d0, (d0 // 2) % 2::2] = RE_USAGE["PDSCH-DMRS"]

        symlist = self._dmrs_symlist()
        vals = self._dmrs_values(slot)                # (nd, ant, rb12)
        res, vs = [], []
        for k, sym in enumerate(symlist):
            start = sym * n_sc + rb_start * 12
            for m in range(n_layers):
                delta = ((ports[m] - 1000) // 2) % 2
                if np.any(usage[:, start + delta: start + rb_size * 12: 2]
                          == RE_USAGE["CSI-RS"]):
                    raise AssertionError("DMRS collides with CSI-RS")
            seg = usage[0, start: start + rb_size * 12].reshape(rb_size, 12)
            keep = ~np.any(seg == RE_USAGE["SSB"], axis=1)   # skip SSB PRBs
            prb_cols = (start + 12 * np.flatnonzero(keep))[:, None] \
                + np.arange(12)
            res.append(prb_cols.reshape(-1))
            vs.append(vals[k].reshape(-1, rb_size, 12)[:, keep]
                      .reshape(vals.shape[1], -1))
            usage[:n_layers, prb_cols] = re_map_prb[:, None, :]
        write_res(fd_slot, np.arange(vals.shape[1])[:, None],
                  np.concatenate(res)[None, :], np.concatenate(vs, axis=1))

    def _alloc_res(self) -> np.ndarray:
        """The allocation's REs, symbol by symbol, subcarriers ascending."""
        cfg = self.cfg
        n_sc = 12 * self.prb_size
        syms = np.arange(cfg["StartSymbolIndex"],
                         cfg["StartSymbolIndex"] + cfg["NrOfSymbols"])
        return (syms[:, None] * n_sc + cfg["ResAlloType1"]["RBStart"] * 12
                + np.arange(cfg["ResAlloType1"]["RBSize"] * 12)).reshape(-1)

    def _data_mapping_prepare(self, usage) -> int:
        """Mark the allocation's empty REs (first antenna's usage) as PDSCH
        data on every antenna -> their number. Raises AssertionError where
        the allocation overlaps PDCCH REs."""
        alloc = self._alloc_res()
        first = usage[0, alloc]
        if np.any(np.isin(first, [RE_USAGE["PDCCH-DATA"],
                                  RE_USAGE["PDCCH-DMRS"]])):
            raise AssertionError("PDSCH overlaps PDCCH resources")
        empty = alloc[first == RE_USAGE["empty"]]
        usage[:, empty] = RE_USAGE["PDSCH-DATA"]
        return int(empty.size)

    def _data_columns(self, usage) -> np.ndarray:
        """The REs the data symbols go to, in mapping order: the
        allocation's REs whose first antenna's usage is PDSCH data."""
        alloc = self._alloc_res()
        return alloc[usage[0, alloc] == RE_USAGE["PDSCH-DATA"]]


# The receive path (phy/pdsch_rx.py) attaches its methods to Pdsch when
# it is imported, whichever of the two modules a caller imports first.
from python_5gtoolbox_tpu_torch.phy import pdsch_rx  # noqa: E402,F401
