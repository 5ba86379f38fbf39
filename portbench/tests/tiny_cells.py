"""The cells of the benchmark's own tests, cut to a size the CPU holds
(BW 20 MHz, 51 PRB, 2 slots a point, one compared point)."""
from __future__ import annotations

import pathlib
import random

from portbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("pdsch_100mhz.tdla30_batched", "pusch_100mhz.tdla30_batched",
         "pdsch_100mhz.ml2_vs_mmse_rayleigh")
PER_SLOT = "pdsch_100mhz.tdla30_per_slot"


# a cell kept under Open questions: its traffic and limits files are
# there, its BENCHMARK.json entry is not
OPEN_CELLS = {PER_SLOT: "pdsch_100mhz_2x4_64qam"}


def tiny(name: str, root: pathlib.Path = ROOT) -> spec.Cell:
    """The cell at BW 20 MHz / 51 PRB, 2 slots a point, one compared
    point; ML2 on QPSK, so that the CPU holds its candidates. root: the
    checkout whose files it is read from."""
    bench = spec.load(root)
    if name in OPEN_CELLS:
        bench["workloads"].append(dict(name=name, config=OPEN_CELLS[name],
                                       traffic=name, chips=1))
    cell = spec.cell(root, bench, name)
    cell.config["carrier"]["BW"] = 20
    cell.config["channel_config"]["ResAlloType1"]["RBSize"] = 51
    cell.traffic.update(slots_per_point=2, trace_points=1,
                        check=dict(points=1, among_first=2))
    if "ML2-IRC-soft" in cell.traffic["equalizers"]:
        cell.config["channel_config"]["mcs_index"] = 2
    return cell


# UCI on the PUSCH: HARQ-ACK in the Reed-Muller small-block code, CSI
# parts 1 and 2 CA-polar coded. name -> (bits, then the configuration's
# keys: enable, size, payload, beta-offset index with its value)
UCI_STREAMS = dict(
    ack=(7, "EnableACK", "NumACKBits", "ACKbits", "I_HARQ_ACK_offset", 11),
    csi1=(40, "EnableCSI1", "NumCSI1Bits", "CSI1bits", "I_CSI1offset", 13),
    csi2=(40, "EnableCSI2", "NumCSI2Bits", "CSI2bits", "I_CSI2offset", 13))
UCI_BITS = {name: s[0] for name, s in UCI_STREAMS.items()}


def with_uci(cell: spec.Cell, seed: int = 5) -> spec.Cell:
    """The PUSCH cell with HARQ-ACK, CSI part 1 and part 2 multiplexed
    (UCI_STREAMS; the payload bits drawn from seed)."""
    rng = random.Random(seed)
    cfg = cell.config["channel_config"]
    for n, en, nb, bits, offset, index in UCI_STREAMS.values():
        cfg.update({en: 1, nb: n, offset: index,
                    bits: [rng.randint(0, 1) for _ in range(n)]})
    return cell
