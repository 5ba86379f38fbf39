"""The result line and the refusals of run.py, driven on the CPU: the
card's look is patched, the run measured on the CPU at a small size."""
from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness, run as run_mod, spec
from portbench.tests.tiny_cells import CELLS, tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run_mod.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1", "--trace", "0"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as exc:
        run_mod.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                      "1", "--trace", "0"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def _drive(monkeypatch, capsys, trace: int, seed: int = 2 ** 31 + 12345):
    """run.main on the CPU at the small size -> the parsed last line."""
    cell = tiny(CELLS[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(spec, "cell", lambda *a: cell)
    measure = harness.measure
    monkeypatch.setattr(harness, "measure", lambda c, s, sec, tr, dev, t0:
                        measure(c, s, sec, tr, "cpu", t0))
    run_mod.main(["--workload", CELLS[0], "--seed", str(seed),
                  "--seconds", "0.5", "--trace", str(trace)])
    out, err = capsys.readouterr()
    last = out.strip().splitlines()[-1]
    return json.loads(last), err


def test_result_line_untraced(monkeypatch, capsys):
    line, err = _drive(monkeypatch, capsys, 0)
    assert list(line) == LINE_KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"sim_slots_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["platform"] == "gpu"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name} " in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_result_line_traced(monkeypatch, capsys):
    line, _ = _drive(monkeypatch, capsys, 1)
    assert list(line) == LINE_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for part in line["breakdown"].values():
        assert len(part) <= 10
    names = set(line["metrics"])
    assert {"tx_ms_per_slot", "channel_ms_per_slot",
            "rx_lowphy_ms_per_slot", "rx_batch_ms_per_slot"} <= names
    assert "channel_est_ms_per_slot" not in names
    assert "banded_fir_roofline" not in names      # no kernel on the CPU
    assert "ldpc_iterations_per_slot" not in names  # counted on the card


def test_run_keeps_the_stage_timers_counters(monkeypatch):
    """After the window Run holds the counters of the staged sub-window:
    here one counted a batched equalizer call."""
    from python_5gtoolbox_tpu_torch.rx import batch_core
    from python_5gtoolbox_tpu_torch.utils import profiling
    orig = batch_core.equalize_and_demod_traced
    calls = []

    def fn(*a):
        calls.append(profiling.active())
        profiling.count("equalizer_calls", 1)
        return orig(*a)
    monkeypatch.setattr(batch_core, "equalize_and_demod_traced", fn)
    res = harness.measure(tiny(CELLS[0]), 2 ** 31 + 26, 0.1, True, "cpu",
                          time.perf_counter())
    run = res["run"]
    staged = calls[-1]
    assert run.counters == {"equalizer_calls": calls.count(staged)} != {}
    assert run.counter_per_slot("equalizer_calls") == \
        calls.count(staged) / run.stage_slots


def test_setup_counts_from_process_start():
    cell = tiny(CELLS[0])
    t0 = time.perf_counter() - 100.0
    res = harness.measure(cell, 7, 0.1, False, "cpu", t0)
    assert res["setup_s"] > 100.0
