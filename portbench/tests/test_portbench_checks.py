"""The comparison that decides `correct`, at a size the CPU holds: the
program agrees with the reference, the bfloat16 control and each fault
planted in the timed path come out not correct."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import calibrate, compare, harness
from portbench.tests.tiny_cells import CELLS, PER_SLOT, tiny

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
