"""CSI-RS generation and RE mapping, TS 38.211 7.4.1.5 rows 1-5.

Port of python_5gtoolbox_tpu/phy/csirs.py. Behavior parity targets:
py5gphy/nr_csirs/nr_csirs.py:12-84, nr_csirs_row{1..5}_process.py and
nr_csirs_info.py:4: rows 1-5 of Table 7.4.1.5.3-1 (1/2/4 ports, noCDM /
fd-CDM2, density 3 / 1 / 0.5 even/odd), periodicity/slot-offset gating,
CSI-RS-RSV reservation semantics (including which ports mark
reservations, matching the reference's row-specific choices exactly).

The row writers collect (port, RE, value) triples on the host; process
writes them into the slot grid tensor with one indexed write and marks
the host usage map.
"""
from __future__ import annotations

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.modulation import modulate_np
from python_5gtoolbox_tpu_torch.ops.prbs import gen_prbs_np
from python_5gtoolbox_tpu_torch.phy.grid import write_res
from python_5gtoolbox_tpu_torch.utils.numerology import (RE_USAGE,
                                                         carrier_prb_size)

_CSIRS = RE_USAGE["CSI-RS"]
_RSV = RE_USAGE["CSI-RS-RSV"]


def validate_config(cfg: dict, prb_size: int) -> bool:
    row = cfg["frequencyDomainAllocation"]["row"]
    bits = cfg["frequencyDomainAllocation"]["bitstring"]
    ports, density = cfg["nrofPorts"], cfg["density"]
    cdm = cfg["cdm_type"]
    assert row in (1, 2, 3, 4, 5)
    if row == 1:
        assert ports == 1 and density == "three" and cdm == "noCDM"
        assert len(bits) >= 4 and "1" in bits[-4:]
    elif row == 2:
        assert ports == 1 and cdm == "noCDM"
        assert density in ("dot5evenPRBs", "dot5oddPRBs", "one")
        assert len(bits) >= 12 and "1" in bits[-12:]
    elif row == 3:
        assert ports == 2 and cdm == "fd-CDM2"
        assert density in ("dot5evenPRBs", "dot5oddPRBs", "one")
        assert len(bits) >= 6 and "1" in bits[-6:]
    else:
        assert ports == 4 and density == "one" and cdm == "fd-CDM2"
        assert len(bits) >= (3 if row == 4 else 6)
    assert 0 <= cfg["firstOFDMSymbolInTimeDomain"] <= 13
    assert cfg["startingRB"] < prb_size
    assert 24 <= cfg["nrofRBs"] <= prb_size + 1 and cfg["nrofRBs"] % 4 == 0
    assert cfg["periodicity"] in (4, 5, 8, 10, 16, 20, 32, 40, 64, 80, 160,
                                  320, 640)
    assert cfg["slotoffset"] < cfg["periodicity"]
    return True


def _seq(cfg, slot, sym, re_per_prb):
    sid = cfg["scramblingID"]
    cinit = ((2 ** 10) * (14 * slot + sym + 1) * (2 * sid + 1) + sid) % (2 ** 31)
    n = 2 * (cfg["startingRB"] + cfg["nrofRBs"] + 1) * re_per_prb
    return modulate_np(gen_prbs_np(cinit, n), "qpsk")


def _k0(cfg, scale=1):
    bits = cfg["frequencyDomainAllocation"]["bitstring"]
    return (len(bits) - 1 - bits.rindex("1")) * scale


class NrCSIRS:
    """CSI-RS channel object with the reference's process() protocol:
    process(fd_slot, usage, sfn, slot) on a (ant, 14*n_sc) complex64 grid
    tensor and a host int8 usage map of the same shape."""

    def __init__(self, carrier_config: dict, csirs_config: dict):
        self.carrier = carrier_config
        self.cfg = csirs_config
        self.prb_size = carrier_prb_size(carrier_config["scs"],
                                         carrier_config["BW"])
        validate_config(csirs_config, self.prb_size)

    def is_active_slot(self, sfn: int, slot: int) -> bool:
        n_slot_frame = 10 * self.carrier["scs"] // 15
        return not (n_slot_frame * sfn + slot - self.cfg["slotoffset"]) \
            % self.cfg["periodicity"]

    def process(self, fd_slot: torch.Tensor, usage: np.ndarray, sfn: int,
                slot: int):
        if not self.is_active_slot(sfn, slot):
            return fd_slot, usage
        row = self.cfg["frequencyDomainAllocation"]["row"]
        ports, res, vals = [], [], []

        def put(port, re, v):
            ports.append(np.full(re.size, port))
            res.append(re)
            vals.append(np.broadcast_to(v, re.shape))
        getattr(self, f"_row{row}")(put, usage, slot)
        write_res(fd_slot, np.concatenate(ports), np.concatenate(res),
                  np.concatenate(vals))
        return fd_slot, usage

    # -- helpers -----------------------------------------------------------
    def _clip(self, rb_start, nrb):
        if rb_start + nrb > self.prb_size:
            nrb = self.prb_size - rb_start
        return rb_start, nrb

    def _rb_for_density(self, density):
        rb_start = self.cfg["startingRB"]
        if density == "dot5evenPRBs" and rb_start % 2 == 1:
            rb_start += 1
        if density == "dot5oddPRBs" and rb_start % 2 == 0:
            rb_start += 1
        return self._clip(rb_start, self.cfg["nrofRBs"])

    # -- row implementations: put(port, REs, values) per write ---------------
    def _row1(self, put, usage, slot):
        cfg = self.cfg
        sym = cfg["firstOFDMSymbolInTimeDomain"]
        seq = _seq(cfg, slot, sym, 3)
        rb_start, nrb = self._clip(cfg["startingRB"], cfg["nrofRBs"])
        n_sc = 12 * self.prb_size
        start = n_sc * sym + rb_start * 12 + _k0(cfg)
        re = np.arange(start, start + nrb * 12, 4)
        put(0, re, seq[3 * cfg["startingRB"]:][: nrb * 3])
        usage[0, re] = _CSIRS
        if usage.shape[0] > 1:
            usage[1:, re] = _RSV

    def _row2(self, put, usage, slot):
        cfg = self.cfg
        sym = cfg["firstOFDMSymbolInTimeDomain"]
        seq = _seq(cfg, slot, sym, 1)
        density = cfg["density"]
        rb_start, nrb = self._rb_for_density(density)
        n_sc = 12 * self.prb_size
        start = n_sc * sym + rb_start * 12 + _k0(cfg)
        if density == "one":
            sel = seq[cfg["startingRB"]: cfg["startingRB"] + nrb]
            step = 12
        else:
            sel = seq[rb_start // 2: rb_start // 2 + nrb // 2]
            step = 24
        re = np.arange(start, start + nrb * 12, step)
        put(0, re, sel)
        usage[0, re] = _CSIRS
        if usage.shape[0] > 1:
            usage[1:, re] = _RSV

    def _row3(self, put, usage, slot):
        cfg = self.cfg
        sym = cfg["firstOFDMSymbolInTimeDomain"]
        seq = _seq(cfg, slot, sym, 2)
        density = cfg["density"]
        rb_start, nrb = self._rb_for_density(density)
        n_sc = 12 * self.prb_size
        k0 = _k0(cfg, 2)
        wfk = [[1, 1], [1, -1]]
        for port in (0, 1):
            for kp in (0, 1):
                start = n_sc * sym + rb_start * 12 + kp + k0
                if density == "one":
                    sel = seq[cfg["startingRB"] * 2 + kp:
                              cfg["startingRB"] * 2 + kp + nrb * 2: 2]
                    step = 12
                else:
                    sel = seq[rb_start + kp: rb_start + kp + nrb: 2]
                    step = 24
                re = np.arange(start, start + nrb * 12, step)
                put(port, re, wfk[port][kp] * sel)
                usage[port, re] = _CSIRS

    def _row4(self, put, usage, slot):
        cfg = self.cfg
        sym = cfg["firstOFDMSymbolInTimeDomain"]
        seq = _seq(cfg, slot, sym, 2)
        rb_start, nrb = self._clip(cfg["startingRB"], cfg["nrofRBs"])
        n_sc = 12 * self.prb_size
        k0 = _k0(cfg, 4)
        wfk = [[1, 1], [1, -1]]
        for port in range(4):
            kbar = k0 + (port // 2) * 2
            w = wfk[port % 2]
            for kp in (0, 1):
                start = n_sc * sym + rb_start * 12 + kp + kbar
                sel = seq[cfg["startingRB"] * 2 + kp:
                          cfg["startingRB"] * 2 + kp + nrb * 2: 2]
                re = np.arange(start, start + nrb * 12, 12)
                put(port, re, w[kp] * sel)
                usage[port, re] = _CSIRS
                if port == 0:
                    rsv = np.arange(start + 2, start + nrb * 12, 12)
                    usage[port, rsv] = _RSV

    def _row5(self, put, usage, slot):
        cfg = self.cfg
        rb_start, nrb = self._clip(cfg["startingRB"], cfg["nrofRBs"])
        n_sc = 12 * self.prb_size
        k0 = _k0(cfg, 2)
        wfk = [[1, 1], [1, -1]]
        for port in range(4):
            sym = cfg["firstOFDMSymbolInTimeDomain"] + port // 2
            seq = _seq(cfg, slot, sym, 2)
            w = wfk[port % 2]
            for kp in (0, 1):
                start = n_sc * sym + rb_start * 12 + kp + k0
                sel = seq[cfg["startingRB"] * 2 + kp:
                          cfg["startingRB"] * 2 + kp + nrb * 2: 2]
                re = np.arange(start, start + nrb * 12, 12)
                put(port, re, w[kp] * sel)
                usage[port, re] = _CSIRS
                if port == 2:
                    usage[0, re] = _RSV
