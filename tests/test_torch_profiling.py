"""PyTorch port, utils/profiling.py and utils/platform.py against the JAX
package's: the same report text and routing offenders for the same
stage statistics, the CPU stage timer, the trace scope, and the device
routing (the card unless the host is asked for). The CUDA-event timer
is held on the card (tests/test_torch_cuda.py).

Then what the port adds: spans and counters of the active profiler,
nothing recorded without one, the spans on a torch.profiler trace, and
the PDSCH and PUSCH sweeps recording each TX and RX span once a point
with the same results as without a profiler."""
import contextlib
import time
import warnings

import numpy as np
import pytest
import torch

from python_5gtoolbox_tpu.utils import profiling as jprof

from python_5gtoolbox_tpu_torch.utils import platform as tplat
from python_5gtoolbox_tpu_torch.utils import profiling as tprof

STATS = {"rx_process[MMSE-IRC]": (40, 1.25, 0.0, "items"),
         "channel_est": (33, 0.5, 0.0, "items"),
         "ldpc_decode": (3, 0.012345, 1536.0, "cw"),
         "tx_waveform": (2, 2.0, 40.0, "slots"),
         "rx_process[ZF]": (32, 0.1, 0.0, "items")}


def _filled(stats_cls, prof):
    for name, (calls, secs, items, unit) in STATS.items():
        prof.stats[name] = stats_cls(calls=calls, seconds=secs, items=items,
                                     unit=unit)
    return prof


def test_report_matches_jax():
    j = _filled(jprof._StageStats, jprof.StageProfiler())
    t = _filled(tprof._StageStats, tprof.StageProfiler("cpu"))
    assert t.report() == j.report()
    for name in STATS:
        assert t.rate(name) == j.rate(name)
    t.reset()
    assert t.report() == jprof.StageProfiler().report()


@pytest.mark.parametrize("limit", [32, 35, 100])
def test_dispatch_routing_flags_what_jax_flags(limit):
    j = _filled(jprof._StageStats, jprof.StageProfiler())
    t = _filled(tprof._StageStats, tprof.StageProfiler("cpu"))
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ref = j.check_dispatch_routing(limit, backend="tpu")
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = t.check_dispatch_routing(limit, backend="cuda")
    assert got == ref
    assert len(wt) == len(wj) == len(ref)
    assert t.check_dispatch_routing(limit) == []     # the profiler's cpu
    assert t.check_dispatch_routing(limit, backend="cpu") == \
        j.check_dispatch_routing(limit, backend="cpu") == []


def test_cpu_stage_timer():
    p = tprof.StageProfiler("cpu")
    for _ in range(3):
        with p.stage("work", items=10, unit="cw"):
            sum(range(20000))
    s = p.stats["work"]
    assert (s.calls, s.items, s.unit) == (3, 30, "cw")
    assert s.seconds > 0 and p.rate("work") == 30 / s.seconds
    with pytest.raises(ZeroDivisionError):
        with p.stage("raises", items=1):
            1 / 0
    assert p.stats["raises"].calls == 1


def test_trace_scope_writes_a_chrome_trace(tmp_path):
    with tprof.xla_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_select_platform(monkeypatch):
    monkeypatch.delenv("PY5G_FORCE_CPU", raising=False)
    for profile in ("sweep", "latency"):
        assert tplat.select_platform(profile, "cpu") == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tplat.select_platform(profile)
    with pytest.raises(ValueError, match="profile"):
        tplat.select_platform("fast")
    monkeypatch.setenv("PY5G_FORCE_CPU", "1")
    for profile in ("sweep", "latency"):
        assert tplat.select_platform(profile) == torch.device("cpu")
    assert tplat.use_cpu_for_host_pipelines() == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.StageProfiler()


# ---- spans, counters and the active profiler ------------------------------

class _Calls:
    """Counting stand-ins for torch.cuda.Event and record_function."""

    def __init__(self):
        self.events = 0
        self.ranges = []

    def event(self, enable_timing=False):
        calls = self

        class _Event:
            def __init__(self):
                calls.events += 1

            def record(self, stream=None):
                pass

            def elapsed_time(self, other):
                return 2.0

        return _Event()

    def record_function(self, name, args=None):
        self.ranges.append(name)
        return contextlib.nullcontext()


@pytest.fixture
def calls(monkeypatch):
    """CUDA events and record_function ranges counted, a torch profiler
    taken as running (so that every open stage or span would open its
    range) and the card's stream and synchronize made no-ops."""
    c = _Calls()
    monkeypatch.setattr(torch.cuda, "Event", c.event)
    monkeypatch.setattr(torch.profiler, "record_function", c.record_function)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    return c


def _card_profiler():
    """A StageProfiler that takes the card's path (events on the stream)
    on the stand-ins of the calls fixture."""
    p = tprof.StageProfiler("cpu")
    p.device = torch.device("cuda")
    return p


def test_span_without_a_profiler_records_nothing(calls):
    assert tprof.active() is None
    assert tprof.span("tx.grid") is tprof.span("rx.ldpc", items=3)
    with tprof.span("tx.grid"):
        with tprof.span("tx.symbols", items=2, unit="cw"):
            tprof.count("ldpc_iterations", 5)
            tprof.count("ldpc_iterations", torch.ones(4))
    assert (calls.events, calls.ranges) == (0, [])
    # the same spans under an open stage: two events and one range each
    p = _card_profiler()
    with p.stage("tx_waveform"):
        assert tprof.active() is p
        with tprof.span("tx.grid"):
            pass
    assert tprof.active() is None
    assert calls.events == 4
    assert calls.ranges == ["tx_waveform", "tx.grid"]
    assert p.stats["tx.grid"].seconds == pytest.approx(2e-3)


def test_nested_spans_record_calls_and_parent():
    p = tprof.StageProfiler("cpu")
    other = tprof.StageProfiler("cpu")
    for _ in range(2):
        with p.stage("rx_batch[MMSE-IRC]"):
            with tprof.span("rx.ce"):
                with tprof.span("inner", items=3, unit="cw"):
                    pass
            with tprof.span("rx.ldpc", items=20, unit="cw"):
                with other.stage("elsewhere"):
                    with tprof.span("deep"):
                        pass
    s = p.stats
    assert list(s) == ["rx_batch[MMSE-IRC]", "rx.ce", "inner", "rx.ldpc"]
    assert [v.calls for v in s.values()] == [2, 2, 2, 2]
    assert [v.parent for v in s.values()] == [
        None, "rx_batch[MMSE-IRC]", "rx.ce", "rx_batch[MMSE-IRC]"]
    assert (s["inner"].items, s["inner"].unit) == (6, "cw")
    assert s["rx.ldpc"].items == 40
    # a stage of another profiler opens its own scope: its spans are its
    assert other.stats["elsewhere"].parent is None
    assert other.stats["deep"].parent == "elsewhere"
    assert s["rx_batch[MMSE-IRC]"].seconds >= s["rx.ce"].seconds


def test_spans_nest_in_the_benchmark_stage_range(monkeypatch):
    """Under a CPU torch.profiler run the program's stage and span names
    are host ranges nested in the benchmark's stage:<name> range, and
    portbench.trace labels an idle gap of the card by the innermost
    span: '<stage>/<span>', or '<stage>/<stage>' outside every span."""
    from portbench import trace

    p = tprof.StageProfiler("cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as tp:
        with torch.profiler.record_function("stage:tx_waveform"), \
                p.stage("tx_waveform"):
            time.sleep(0.004)
            with tprof.span("tx.grid"):
                time.sleep(0.004)
            time.sleep(0.004)
    host = {e.name: e.time_range for e in tp.events()
            if e.device_type == torch.autograd.DeviceType.CPU}
    outer, st, sp = (host["stage:tx_waveform"], host["tx_waveform"],
                     host["tx.grid"])
    assert outer.start <= st.start <= sp.start
    assert sp.end <= st.end <= outer.end
    assert p.stats["tx.grid"].parent == "tx_waveform"
    # the card busy all the time but for a gap inside the span and one
    # between the span and the stage's end
    lo, hi = outer.start, outer.end
    g1 = (sp.start + sp.end) / 2
    g2 = (sp.end + st.end) / 2
    busy = [("k", lo, g1 - 50), ("k", g1 + 50, g2 - 50), ("k", g2 + 50, hi)]
    gaps = trace.idle_gaps(tp, busy, lo, hi)
    assert set(gaps) == {"tx_waveform/tx.grid", "tx_waveform/tx_waveform"}


def test_counters_sum_numbers_and_tensors(calls):
    p = _card_profiler()
    with p.stage("rx.ldpc"):
        tprof.count("ldpc_iterations", torch.tensor([3, 4, 16],
                                                    dtype=torch.int32))
        tprof.count("ldpc_iterations", 2)
        p.count("ldpc_iterations", torch.tensor([1], dtype=torch.int32))
        tprof.count("slots", 20)
        tprof.count("energy", torch.tensor([0.25, 0.5]))
    # the tensors are summed where they live and read with the events
    assert len(p._pending_counts) == 3 and len(p._pending) == 1
    assert p.counters == {"ldpc_iterations": 26, "slots": 20,
                          "energy": 0.75}
    assert not p._pending_counts and not p._pending
    assert isinstance(p.counters["ldpc_iterations"], int)
    p.count("slots", 1)
    assert p.stats["rx.ldpc"].calls == 1 and p.counters["slots"] == 21
    p.reset()
    assert p.counters == {} and dict(p.stats) == {}


def test_report_appends_counters_only_when_there_are_some():
    t = _filled(tprof._StageStats, tprof.StageProfiler("cpu"))
    plain = t.report()
    assert plain == _filled(jprof._StageStats, jprof.StageProfiler()).report()
    t.count("ldpc_iterations", 123456)
    t.count("ldpc_iterations", torch.tensor([4, 4], dtype=torch.int32))
    lines = t.report().splitlines()
    assert "\n".join(lines[:len(STATS) + 1]) == plain
    assert lines[len(STATS) + 1].split() == ["counter", "total"]
    assert lines[len(STATS) + 2].split() == ["ldpc_iterations", "123,464"]
    assert len(lines) == len(STATS) + 3


# ---- the sweeps: spans once per point, the same results without them -------

DL_SPANS = ("tx.sch_encode", "tx.symbols", "tx.grid", "low_phy")
RX_SPANS = ("rx.prepare", "rx.ce", "rx.gather", "rx.equalize", "rx.ratematch",
            "rx.ldpc")
SWEEP_CE = dict(CE_algo="DFT", L_symm_left_in_ns=200, L_symm_right_in_ns=200,
                eRB=2, enable_TO_comp=True, enable_FO_est=False,
                enable_FO_comp=False)
SWEEP_LDPC = dict(L=16, algo="min-sum", alpha=0.8, beta=0.3)
SWEEP_SNRS = [-20.0, 25.0]          # one point fails, one passes


def _sweep_case(link):
    """(run, carrier, channel config, channel model, equalizers, batch RX
    class) of a small-width CPU sweep: BW 10, 16 RBs, 2 layers on 2x4."""
    from python_5gtoolbox_tpu_torch.models import channel as chan_mod
    from python_5gtoolbox_tpu_torch.phy.pdsch import Pdsch
    from python_5gtoolbox_tpu_torch.phy.pusch import NrPUSCH
    from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as dsim
    from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
    from python_5gtoolbox_tpu_torch.utils.config import (get_default_config,
                                                         merged)
    chan = chan_mod.gen_channel_model_config(
        model_format="customized", Nt=2, Nr=4,
        multi_paths=[[0, 0, "Rayleigh", 0, 0]])
    base = dict(BW=10, scs=30, num_of_ant=2, Nr=4, maxMIMO_layers=2, PCI=1,
                carrier_frequency_in_mhz=3840.0)
    if link == "DL":
        carrier = merged(get_default_config("dl_carrier"), base)
        cfg = merged(get_default_config("pdsch"),
                     dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                          rv=[0], data_source=[], StartSymbolIndex=2,
                          NrOfSymbols=12))
        cfg["DMRS"].update(nNIDnSCID=1, NumCDMGroupsWithoutData=1,
                           DMRSAddPos=1)
        cfg["precoding_matrix"] = np.empty(0)
        run, algos, cls = dsim.run_pdsch_throughput, ["MMSE-IRC", "ZF"], Pdsch
    else:
        carrier = merged(get_default_config("ul_carrier"), base)
        cfg = merged(get_default_config("pusch"),
                     dict(mcs_index=2, mcs_table="256QAM", num_of_layers=2,
                          rv=[0], data_source=[], StartSymbolIndex=0,
                          NrOfSymbols=14, nTransPrecode=0, EnableULSCH=1,
                          EnableACK=0, EnableCSI1=0, EnableCSI2=0))
        cfg["DMRS"].update(NumCDMGroupsWithoutData=1, DMRSAddPos=1)
        run, algos, cls = usim.run_pusch_throughput, ["MMSE-IRC"], NrPUSCH
    cfg["ResAlloType1"].update(RBStart=0, RBSize=16)
    return run, carrier, cfg, chan, algos, cls


def _run_sweep(link, prof, monkeypatch):
    """The sweep -> (pass rates, [(flags, blocks)] of every
    rx_process_batch call)."""
    run, carrier, cfg, chan, algos, cls = _sweep_case(link)
    outs = []
    real = cls.rx_process_batch

    def spy(self, *a, **kw):
        got = real(self, *a, **kw)
        outs.append((got[0].clone(), got[1].clone()))
        return got
    monkeypatch.setattr(cls, "rx_process_batch", spy)
    res = run(carrier, cfg, chan, SWEEP_SNRS, algos, n_slots=2,
              ce_config=SWEEP_CE, ldpc_config=SWEEP_LDPC, seed=7,
              device="cpu", prof=prof)
    monkeypatch.setattr(cls, "rx_process_batch", real)
    return res, outs, algos


@pytest.mark.parametrize("link", ["DL", "UL"])
def test_sweep_records_every_span_once_per_point(link, monkeypatch):
    """A StageProfiler on the sweep gets each TX span once a point (in
    tx_waveform) and each RX span once a point and equalizer (in
    rx_batch[<equalizer>]); the pass rates and every rx_process_batch
    flag and block are those of the sweep with prof=None."""
    prof = tprof.StageProfiler("cpu")
    res, outs, algos = _run_sweep(link, prof, monkeypatch)
    ref, ref_outs, _ = _run_sweep(link, None, monkeypatch)
    n = len(SWEEP_SNRS)
    s = prof.stats
    assert set(s) == {"tx_waveform", "channel", "rx_lowphy", *DL_SPANS,
                      *RX_SPANS, *(f"rx_batch[{a}]" for a in algos)}
    for name in ("tx_waveform", "channel", "rx_lowphy"):
        assert (s[name].calls, s[name].parent) == (n, None)
    for name in DL_SPANS:
        assert (s[name].calls, s[name].parent) == (n, "tx_waveform")
    for name in RX_SPANS:
        assert s[name].calls == n * len(algos)
        assert s[name].parent == f"rx_batch[{algos[-1]}]"
    assert s["rx.ldpc"].unit == "cw" and s["rx.ldpc"].items > 0
    assert prof.counters == {}           # no iterations from the plain decoder
    assert res == ref
    assert all(res[a] == [0.0, 1.0] for a in algos)
    assert len(outs) == len(ref_outs) == n * len(algos)
    for (ok, blk), (ok_r, blk_r) in zip(outs, ref_outs):
        assert torch.equal(ok, ok_r) and torch.equal(blk, blk_r)


def test_sweep_without_a_profiler_opens_nothing(calls, monkeypatch):
    """prof=None: the sweep creates no CUDA event and opens no
    record_function range, though the torch profiler is taken as
    running; with a profiler on the card's path it opens one range and
    two events for each stage and span."""
    _run_sweep("UL", None, monkeypatch)
    assert (calls.events, calls.ranges) == (0, [])
    prof = _card_profiler()
    _run_sweep("UL", prof, monkeypatch)
    assert calls.ranges[:5] == ["tx_waveform", "tx.sch_encode",
                                "tx.symbols", "tx.grid", "low_phy"]
    n = sum(st.calls for st in prof.stats.values())
    assert len(calls.ranges) == n and calls.events == 2 * n
