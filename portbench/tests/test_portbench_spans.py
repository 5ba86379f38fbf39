"""The readers of the program's spans inside TX and the batched RX, on a
synthetic Run: milliseconds a slot of their span, nothing where the span
is missing (a program without it), and tx_lowphy_ms_per_slot the sum of
low_phy and channel_filter; the readers of its counters: the count a
slot, nothing where the counter is missing."""
from __future__ import annotations

import pytest

from portbench import spec
from portbench.harness import Run
from portbench.tests.tiny_cells import ROOT

SPANS = {"tx_sch_encode_ms_per_slot": "tx.sch_encode",
         "tx_symbols_ms_per_slot": "tx.symbols",
         "tx_grid_ms_per_slot": "tx.grid",
         "tx_lowphy_ms_per_slot": "low_phy",
         "rx_prepare_ms_per_slot": "rx.prepare",
         "rx_ce_ms_per_slot": "rx.ce",
         "rx_gather_ms_per_slot": "rx.gather",
         "rx_equalize_ms_per_slot": "rx.equalize",
         "rx_ratematch_ms_per_slot": "rx.ratematch",
         "rx_ldpc_ms_per_slot": "rx.ldpc"}
# what the parent program records: its four stages and nothing inside
PARENT_STAGES = {"tx_waveform": 0.5, "channel": 1.5, "rx_lowphy": 0.01,
                 "rx_batch[MMSE-IRC]": 0.8}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_reads_its_span(metric):
    stages = dict(PARENT_STAGES, **{s: 0.01 * (i + 1) for i, s in
                                    enumerate(sorted(SPANS.values()))})
    run = Run(stages=stages, stage_slots=40)
    got = spec.metric_reader(ROOT, metric).read(run)
    assert got == pytest.approx(1e3 * stages[SPANS[metric]] / 40, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_is_silent_without_its_span(metric):
    run = Run(stages=dict(PARENT_STAGES), stage_slots=40)
    assert spec.metric_reader(ROOT, metric).read(run) is None


def test_tx_lowphy_sums_low_phy_and_channel_filter():
    read = spec.metric_reader(ROOT, "tx_lowphy_ms_per_slot").read
    run = Run(stages=dict(PARENT_STAGES, low_phy=0.2, channel_filter=0.05),
              stage_slots=20)
    assert read(run) == pytest.approx(1e3 * 0.25 / 20, rel=1e-12)
    only_filter = Run(stages=dict(PARENT_STAGES, channel_filter=0.05),
                      stage_slots=20)
    assert read(only_filter) == pytest.approx(1e3 * 0.05 / 20, rel=1e-12)


def test_span_names_leave_the_stage_metrics_as_they_were():
    """No span is read by a stage metric: the four stage readers give the
    same numbers with and without the spans."""
    with_spans = Run(stages=dict(PARENT_STAGES, **{
        s: 1.0 for s in (*SPANS.values(), "channel_filter")}),
        stage_slots=40)
    without = Run(stages=dict(PARENT_STAGES), stage_slots=40)
    for metric in ("tx_ms_per_slot", "channel_ms_per_slot",
                   "rx_lowphy_ms_per_slot", "rx_batch_ms_per_slot"):
        read = spec.metric_reader(ROOT, metric).read
        assert read(with_spans) == read(without) is not None


def test_counter_per_slot():
    run = Run(counters={"ldpc_iterations": 4620, "ml2_kernel_res": 0},
              stage_slots=40)
    assert run.counter_per_slot("ldpc_iterations") == 4620 / 40
    assert run.counter_per_slot("ml2_kernel_res") == 0.0
    assert run.counter_per_slot("polar_decodes") is None
    assert Run(counters={"ldpc_iterations": 10}).counter_per_slot(
        "ldpc_iterations") is None          # no staged slots


def test_ldpc_iterations_reader():
    read = spec.metric_reader(ROOT, "ldpc_iterations_per_slot").read
    run = Run(stages=dict(PARENT_STAGES), counters={"ldpc_iterations": 2280},
              stage_slots=20)
    assert read(run) == 2280 / 20
    assert read(Run(stages=dict(PARENT_STAGES), stage_slots=20)) is None
