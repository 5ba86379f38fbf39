"""PyTorch port, utils/profiling.py and utils/platform.py against the JAX
package's: the same report text and routing offenders for the same
stage statistics, the CPU stage timer, the trace scope, and the device
routing (the card unless the host is asked for). The CUDA-event timer
is held on the card (tests/test_torch_cuda.py)."""
import warnings

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
