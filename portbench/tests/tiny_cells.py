"""The cells of the benchmark's own tests, cut to a size the CPU holds
(BW 20 MHz, 51 PRB, 2 slots a point, one compared point)."""
from __future__ import annotations

import pathlib

from portbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("pdsch_100mhz.tdla30_batched", "pusch_100mhz.tdla30_batched",
         "pdsch_100mhz.ml2_vs_mmse_rayleigh")
PER_SLOT = "pdsch_100mhz.tdla30_per_slot"


# a cell kept under Open questions: its traffic and limits files are
# there, its BENCHMARK.json entry is not
OPEN_CELLS = {PER_SLOT: "pdsch_100mhz_2x4_64qam"}


def tiny(name: str) -> spec.Cell:
    """The cell at BW 20 MHz / 51 PRB, 2 slots a point, one compared
    point; ML2 on QPSK, so that the CPU holds its candidates."""
    bench = spec.load(ROOT)
    if name in OPEN_CELLS:
        bench["workloads"].append(dict(name=name, config=OPEN_CELLS[name],
                                       traffic=name, chips=1))
    cell = spec.cell(ROOT, bench, name)
    cell.config["carrier"]["BW"] = 20
    cell.config["channel_config"]["ResAlloType1"]["RBSize"] = 51
    cell.traffic.update(slots_per_point=2, trace_points=1,
                        check=dict(points=1, among_first=2))
    if "ML2-IRC-soft" in cell.traffic["equalizers"]:
        cell.config["channel_config"]["mcs_index"] = 2
    return cell
