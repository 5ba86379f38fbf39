"""The cell pusch_100mhz_uci.tdla30_batched at a size the CPU holds: the
program agrees with the configuration's own reference
(reference/configs/pusch_100mhz_2x4_64qam_uci.py) on every number, the
bfloat16 control and each fault planted in the UCI path come out not
correct, the cell's metric readers read nothing where the program kept
no such span or counter, and the reference's UCI (reference/uci.py,
written from TS 38.212) agrees with the port's."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import calibrate, compare, harness, probe as probe_mod, spec
from portbench.reference import uci as ref_uci
from portbench.tests.tiny_cells import ROOT, tiny

CPU = torch.device("cpu")
CELL = "pusch_100mhz_uci.tdla30_batched"
STREAMS = ("ack", "csi1", "csi2")
METRICS = {"tx_slot_grids_ms_per_slot": "slot_grids",
           "tx_uci_encode_ms_per_slot": "tx.uci_encode",
           "rx_uci_smallblock_ms_per_slot": "rx.uci.smallblock",
           "rx_uci_polar_ms_per_slot": "rx.uci.polar"}
COUNTER_METRICS = {"polar_graph_captures_per_slot": "polar_graph_captures"}


def test_program_agrees_with_reference():
    """Every number reads 0: the waveforms, the LLRs, the UL-SCH flags
    and each stream's counts. The limits hold all but passed_wrong.ack
    (HARQ-ACK has no CRC: that count reads the channel's errors, which
    the reference shares; bits_mismatch.ack holds the program to it)."""
    cell = tiny(CELL)
    nums = calibrate.program_readings(cell, 2 ** 31 + 17, CPU)
    assert set(nums) == set(cell.limits) | {"passed_wrong.ack"}
    assert all(v == 0.0 for v in nums.values()), nums
    for name in STREAMS:
        assert cell.limits[f"bits_mismatch.{name}"] == 0


def test_control_is_not_correct():
    cell = tiny(CELL)
    nums = calibrate.control_readings(cell, 2 ** 31 + 18, CPU)
    correct, rows = compare.judge(nums, cell.limits)
    assert not correct, rows
    for k in ("tx_err", "channel_err", "grid_err", "llr_err.MMSE-IRC"):
        assert nums[k] > cell.limits[k]


def _plant(monkeypatch, fault):
    """A fault in the UCI streams of the batched RX: a wrong bit or flag
    in what it returns, or a stream the probe no longer finds there."""
    from python_5gtoolbox_tpu_torch.phy import pusch
    if fault == "csi2_missing":
        real_outputs = probe_mod.Probe.outputs

        def outputs(self, key):
            out = real_outputs(self, key)
            del out["streams"]["csi2"]
            return out
        monkeypatch.setattr(probe_mod.Probe, "outputs", outputs)
        return
    real = pusch.NrPUSCH.rx_process_batch

    def fn(*a, **k):
        ok, tb, streams = real(*a, **k)
        name = "ack" if fault == "ack_bit_flipped" else "csi1"
        bits, okk = (t.clone() for t in streams[name])
        if fault == "ack_bit_flipped":
            bits[0, 3] ^= 1
        else:
            okk[-1] = ~okk[-1]
        return ok, tb, dict(streams, **{name: (bits, okk)})
    monkeypatch.setattr(pusch.NrPUSCH, "rx_process_batch", fn)


@pytest.mark.parametrize("fault, number", [
    ("ack_bit_flipped", "bits_mismatch.ack"),
    ("csi1_flag_flipped", "flag_mismatch.csi1"),
    ("csi2_missing", "flag_mismatch.csi2")])
def test_fault_in_the_uci_path_is_not_correct(monkeypatch, fault, number):
    """A wrong HARQ-ACK bit, a flipped CSI part 1 flag and a CSI part 2
    stream missing from the timed path's outputs: a run comes out not
    correct, by the stream's count, and by no other number."""
    _plant(monkeypatch, fault)
    cell = tiny(CELL)
    res = harness.measure(cell, 2 ** 31 + 19, 0.1, False, "cpu",
                          time.perf_counter())
    assert res["correct"] is False, res["rows"]
    rows = {name: value for name, value, _ in res["rows"]}
    assert rows[number] > 0
    assert all(v == 0 for k, v in rows.items()
               if k.split(".")[-1] != number.split(".")[-1])


def test_readers_read_nothing_without_their_spans():
    """On a Run without the spans and counters (the parent's program, the
    CPU for the graph counter) each new reader returns None; with them,
    ms or counts a slot of the staged sub-window."""
    names = {m["name"] for m in spec.load(ROOT)["per_layer"]
             if CELL in m.get("workloads", [])}
    assert names == set(METRICS) | set(COUNTER_METRICS)
    empty = harness.Run(stage_slots=20)
    for name in names:
        assert spec.metric_reader(ROOT, name).read(empty) is None
    run = harness.Run(stages={s: 0.01 for s in METRICS.values()},
                      counters={"polar_graph_captures": 0}, stage_slots=20)
    for name, stage in METRICS.items():
        assert spec.metric_reader(ROOT, name).read(run) == pytest.approx(0.5)
    assert spec.metric_reader(
        ROOT, "polar_graph_captures_per_slot").read(run) == 0


def test_the_import_test_loads_the_new_reference():
    """test_portbench_imports loads every file under reference/ by its
    path: the configuration's module and its UCI module among them."""
    paths = set((ROOT / "portbench/reference").rglob("*.py"))
    for rel in ("configs/pusch_100mhz_2x4_64qam_uci.py", "uci.py"):
        assert ROOT / "portbench/reference" / rel in paths
    cell = tiny(CELL)
    assert cell.reference.__file__.endswith(
        "reference/configs/pusch_100mhz_2x4_64qam_uci.py")


@pytest.mark.parametrize("ack,csi1,csi2,rb", [(7, 40, 40, 51),
                                              (3, 20, 100, 24),
                                              (11, 0, 0, 273)])
def test_reference_uci_agrees_with_the_port(ack, csi1, csi2, rb):
    """reference/uci.py against the port (which the reference never
    imports): the 6.3.2.4 split, the 6.2.7 positions, the coded bits,
    and on noisy LLRs the decoded bits and flags."""
    from python_5gtoolbox_tpu_torch.ops.ldpc.segment import sch_plan
    from python_5gtoolbox_tpu_torch.phy import pusch as tpusch
    from python_5gtoolbox_tpu_torch.phy import pusch_rx as trx
    from python_5gtoolbox_tpu_torch.rx.batch_core import make_uci_decoder

    cell = tiny(CELL)
    cfg = dict(cell.config["channel_config"])
    cfg.update(NumACKBits=ack, NumCSI1Bits=csi1, NumCSI2Bits=csi2,
               EnableCSI1=int(csi1 > 0), EnableCSI2=int(csi2 > 0),
               ResAlloType1=dict(RBStart=0, RBSize=rb))
    carrier = dict(cell.config["carrier"], BW=100)
    obj = tpusch.NrPUSCH(carrier, cfg, device="cpu")
    sym = obj._dmrs_symlist()
    g_total = obj.qm * 2 * obj._tx_layout()[1]
    rm = obj.uci_rm_info(g_total, sym)
    seg = sch_plan(obj.tbsize, obj.rate1024, g_total, obj.qm, 2, None)[3]
    e = ref_uci.rate_match_split(cfg, g_total, sym, seg.C * seg.K, obj.qm)
    assert e == dict(ack=rm["Euci_ack"], csi1=rm["Euci_CSI1"],
                     csi2=rm["Euci_CSI2"], ulsch=rm["G_ULSCH"])
    pos = ref_uci.multiplex_positions(cfg, sym, 2 * obj.qm, e)
    maps = trx.data_control_demux_maps(cfg, sym, rm, obj.qm, g_total)
    for name in ("ulsch",) + STREAMS:
        np.testing.assert_array_equal(pos[name], maps[name], err_msg=name)

    gen = torch.Generator().manual_seed(ack + csi1 + csi2)
    obj.uci_bits = {name: torch.randint(0, 2, (6, n), generator=gen,
                                        dtype=torch.int8)
                    for name, n in zip(STREAMS, (ack, csi1, csi2)) if n}
    rows, off = obj.encode_uci_rows(), 0
    for name, bits in obj.uci_bits.items():
        n = bits.shape[1]
        coded = ref_uci.encode(bits, e[name])
        assert torch.equal(coded, rows[:, off: off + e[name]]), name
        off += e[name]
        # two clean rows, two noisy, two that break
        sigma = torch.tensor([0.2, 0.2, 1.0, 1.0, 3.0, 3.0])[:, None]
        llr = (1.0 - 2.0 * coded.float()) + sigma * torch.randn(
            coded.shape, generator=gen)
        got_bits, got_ok = ref_uci.decode(llr, n)
        port_bits, port_ok = make_uci_decoder(n, e[name], obj.qm)(llr)
        assert torch.equal(got_ok, port_ok), name
        assert torch.equal(got_bits[got_ok], port_bits[port_ok]), name
        assert torch.equal(got_bits[:2], bits[:2]) and bool(got_ok[:2].all())
