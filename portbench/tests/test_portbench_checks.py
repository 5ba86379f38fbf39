"""The comparison that decides `correct`, at a size the CPU holds: the
program agrees with the reference, the bfloat16 control and each fault
planted in the timed path come out not correct."""
from __future__ import annotations

import contextlib
import io
import math
import shutil
import time

import pytest
import torch

from portbench import calibrate, compare, harness, probe as probe_mod
from portbench.reference import chain
from portbench.tests.tiny_cells import (CELLS, PER_SLOT, ROOT, UCI_BITS,
                                        UCI_STREAMS, tiny, with_uci)

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")
PORT = "python_5gtoolbox_tpu_torch"


@pytest.mark.parametrize("name", CELLS + (PER_SLOT,))
def test_program_agrees_with_reference(name):
    """On the CPU the port runs the plain versions of its kernels, the
    arithmetic of the frozen reference: every number reads 0."""
    cell = tiny(name)
    nums = calibrate.program_readings(cell, 2 ** 31 + 17, CPU)
    assert set(nums) == set(cell.limits)
    assert all(v == 0.0 for v in nums.values()), nums


@pytest.mark.parametrize("name", CELLS + (PER_SLOT,))
def test_control_is_not_correct(name):
    """The reference with its signals in bfloat16 in the program's place
    fails the cell's limits."""
    cell = tiny(name)
    nums = calibrate.control_readings(cell, 2 ** 31 + 18, CPU)
    correct, rows = compare.judge(nums, cell.limits)
    assert not correct, rows
    for k in ("tx_err", "channel_err", "grid_err"):
        assert nums[k] > cell.limits[k]


def _channel_left_out(monkeypatch):
    from python_5gtoolbox_tpu_torch.models import channel
    orig = channel.NrChannelModel.filter

    def fn(model, tx, *a, **k):
        out = orig(model, tx, *a, **k)
        return tx[:1].to(out.dtype).expand_as(out).clone()
    monkeypatch.setattr(channel.NrChannelModel, "filter", fn)


def _half_batch(monkeypatch):
    """The RX decodes the first half of the slots and repeats their
    results for the rest."""
    from python_5gtoolbox_tpu_torch.phy import pdsch
    orig = pdsch.Pdsch.rx_process_batch

    def fn(obj, rx, slots, *a, **k):
        half = max(len(slots) // 2, 1)
        ok, tb = orig(obj, rx[:half], slots[:half], *a, **k)[:2]
        reps = -(-len(slots) // half)
        return ok.repeat(reps)[:len(slots)], tb.repeat(reps, 1)[:len(slots)]
    monkeypatch.setattr(pdsch.Pdsch, "rx_process_batch", fn)


def _flag_flipped(monkeypatch):
    from python_5gtoolbox_tpu_torch.phy import pdsch
    orig = pdsch.Pdsch.rx_process_batch

    def fn(*a, **k):
        ok, tb = orig(*a, **k)[:2]
        ok = ok.clone()
        ok[0] = ~ok[0]
        return ok, tb
    monkeypatch.setattr(pdsch.Pdsch, "rx_process_batch", fn)


def _bit_flipped(monkeypatch):
    from python_5gtoolbox_tpu_torch.phy import pdsch
    orig = pdsch.Pdsch.rx_process_batch

    def fn(*a, **k):
        ok, tb = orig(*a, **k)[:2]
        tb = tb.clone()
        tb[0, 0] = 1 - tb[0, 0]
        return ok, tb
    monkeypatch.setattr(pdsch.Pdsch, "rx_process_batch", fn)


def _llr_altered(monkeypatch):
    from python_5gtoolbox_tpu_torch.rx import batch_core
    orig = batch_core.equalize_and_demod_traced

    def fn(*a):
        llr = orig(*a).clone()
        llr[0] = -4 * llr[0]
        return llr
    monkeypatch.setattr(batch_core, "equalize_and_demod_traced", fn)


FAULTS = {"channel_left_out": _channel_left_out, "half_batch": _half_batch,
          "flag_flipped": _flag_flipped, "bit_flipped": _bit_flipped,
          "llr_altered": _llr_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_timed_path_is_not_correct(fault, monkeypatch):
    """A run whose timed path is broken underneath (everything but the
    look for a card) comes out not correct."""
    cell = tiny(CELLS[0])
    cell.traffic["slots_per_point"] = 4     # two slots to leave out
    FAULTS[fault](monkeypatch)
    res = harness.measure(cell, 2 ** 31 + 19, 0.1, False, "cpu",
                          time.perf_counter())
    assert res["correct"] is False, res["rows"]
    assert res["failed"] >= 1


def test_per_slot_flag_flipped_is_not_correct(monkeypatch):
    from python_5gtoolbox_tpu_torch.phy import pdsch
    orig = pdsch.Pdsch.RX_process

    def fn(*a, **k):
        ok, tb, llr = orig(*a, **k)
        return ~torch.as_tensor(ok), tb, llr
    monkeypatch.setattr(pdsch.Pdsch, "RX_process", fn)
    cell = tiny(PER_SLOT)
    res = harness.measure(cell, 2 ** 31 + 20, 0.1, False, "cpu",
                          time.perf_counter())
    assert res["correct"] is False, res["rows"]


@pytest.mark.cuda
def test_program_agrees_with_reference_on_the_card(cuda_device):
    """On the card the port runs its kernels; at the small size the
    numbers stay within the cell's limits."""
    cell = tiny(CELLS[0])
    nums = calibrate.program_readings(cell, 2 ** 31 + 21, cuda_device)
    correct, rows = compare.judge(nums, cell.limits)
    assert correct, rows


STUB = '''"""A reference of its own for one configuration: the frozen chain,
counting its calls."""
from portbench.reference import chain

CALLS = []


def point(cfg, traffic, snr_db, seed, trblks, device, bf16=False,
          llr_noise=0.0):
    CALLS.append(seed)
    return chain.point(cfg, traffic, snr_db, seed, trblks, device,
                       bf16=bf16, llr_noise=llr_noise)
'''


def test_reference_found_by_configuration_name(tmp_path):
    """A new file reference/configs/<configuration>.py is the reference
    that spec.cell gives that configuration's cells, and that calibrate
    and the harness call; other configurations keep chain.point."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    configs = tmp_path / "portbench/reference/configs"
    configs.mkdir()
    (configs / "pusch_100mhz_2x4_64qam.py").write_text(STUB)
    cell = tiny(CELLS[1], root=tmp_path)
    assert cell.reference.point is not chain.point
    calls = cell.reference.CALLS
    nums = calibrate.program_readings(cell, 2 ** 31 + 22, CPU)
    assert len(calls) == 1
    assert set(nums) == set(cell.limits)
    assert all(v == 0.0 for v in nums.values()), nums
    res = harness.measure(cell, 2 ** 31 + 23, 0.1, False, "cpu",
                          time.perf_counter())
    assert res["correct"] is True, res["rows"]
    assert len(calls) == 2
    for name in (CELLS[0], CELLS[2]):
        assert tiny(name, root=tmp_path).reference.point is chain.point


def _probed(cell, **entry_kw):
    """One point (index 1) of cell through harness.Program with the
    probe armed -> (the probe's outputs, the blocks sent). entry_kw goes
    to the sweep entry in place of Program.point's call."""
    program = harness.Program(cell, CPU)
    probe = probe_mod.Probe()
    probe.install()
    try:
        seed = program.seed(2 ** 31 + 24, 1)
        trb = program.trblks(seed)
        probe.arm(1)
        with contextlib.redirect_stdout(io.StringIO()):
            if entry_kw:
                t = cell.traffic
                program.entry(
                    program.carrier, program.ch_cfg, program.chan_cfg,
                    [program.snr(1)], t["equalizers"],
                    n_slots=t["slots_per_point"], ce_config=cell.config["ce"],
                    ldpc_config=cell.config["ldpc"], seed=seed, device=CPU,
                    states=[dict(trblks=trb, taps=None, noise=None)],
                    **entry_kw)
            else:
                program.point(seed, program.snr(1), trb)
        probe.disarm()
    finally:
        probe.uninstall()
    return probe.outputs(1), trb


@pytest.fixture(scope="module")
def uci_point():
    """The tiny PUSCH cell with UCI on, one point through
    harness.Program.point (the slot-batched RX) with the probe armed."""
    cell = with_uci(tiny(CELLS[1]))
    got, trb = _probed(cell)
    return cell, got, trb


def _sent(cell, n_slots: int) -> dict:
    cfg = cell.config["channel_config"]
    return {name: torch.tensor(cfg[s[3]], dtype=torch.int8)
            .repeat(n_slots, 1) for name, s in UCI_STREAMS.items()}


def _check_streams(cell, got, n_slots):
    assert set(got["streams"]) == set(UCI_BITS)
    sent = _sent(cell, n_slots)
    for name, algos in got["streams"].items():
        assert set(algos) == set(cell.traffic["equalizers"])
        for bits, ok in algos.values():
            assert bits.shape == (n_slots, UCI_BITS[name])
            assert bits.dtype == torch.int8
            assert ok.shape == (n_slots,) and ok.dtype == torch.bool
            assert torch.equal(bits, sent[name]) and bool(ok.all())


def test_probe_keeps_each_side_stream(uci_point):
    """Each UCI stream of the batched RX, per equalizer: (Sa, n) bits and
    (Sa,) flags, decoded to the bits sent."""
    cell, got, trb = uci_point
    _check_streams(cell, got, trb.shape[0])


def test_probe_stacks_per_slot_side_streams():
    """The per-slot RX (RX_process with the UCI decode) gives the same
    layout, stacked a slot at a time."""
    cell = with_uci(tiny(CELLS[1]))
    got, trb = _probed(cell, use_batch=False, decode_uci=True)
    _check_streams(cell, got, trb.shape[0])


@pytest.mark.parametrize("fault", ["none", "flag_flipped", "bit_flipped",
                                   "missing"])
@pytest.mark.parametrize("stream", sorted(UCI_BITS))
def test_stream_counts(uci_point, stream, fault):
    """Against a reference that agrees with the program's outputs every
    number reads 0; a flipped flag reads 1 on flag_mismatch, a flipped
    bit in a passed slot 1 on bits_mismatch and passed_wrong, a missing
    stream inf on all three; the other streams read 0. combine sums the
    counts."""
    cell, got, trb = uci_point
    ref = dict(got, sent=_sent(cell, trb.shape[0]), streams={
        name: {a: (b.clone(), o.clone()) for a, (b, o) in algos.items()}
        for name, algos in got["streams"].items()})
    got = dict(got, streams={n: dict(a) for n, a in got["streams"].items()})
    algo = cell.traffic["equalizers"][0]
    bits, ok = got["streams"][stream][algo]
    expect = dict.fromkeys(compare.STREAM_COUNTS, 0.0)
    if fault == "flag_flipped":
        ok = ok.clone()
        ok[0] = ~ok[0]
        expect["flag_mismatch"] = 1.0
    elif fault == "bit_flipped":
        s = int(torch.nonzero(ok)[0])
        bits = bits.clone()
        bits[s, 0] = 1 - bits[s, 0]
        expect.update(bits_mismatch=1.0, passed_wrong=1.0)
    if fault == "missing":
        del got["streams"][stream]
        expect = dict.fromkeys(expect, math.inf)
    else:
        got["streams"][stream][algo] = (bits, ok)
    nums = compare.point_numbers(got, ref, trb)
    assert {k: nums[f"{k}.{stream}"] for k in expect} == expect
    others = {k: v for k, v in nums.items() if not k.endswith("." + stream)}
    assert len(others) == len(nums) - 3
    assert all(v == 0.0 for v in others.values()), others
    both = compare.combine([nums, nums])
    assert {k: both[f"{k}.{stream}"] for k in expect} == {
        k: 2 * v for k, v in expect.items()}
