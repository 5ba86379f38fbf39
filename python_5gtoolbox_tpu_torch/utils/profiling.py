"""Per-stage timing with throughput counters, and a profiler trace scope.

Port of python_5gtoolbox_tpu/utils/profiling.py:

    prof = StageProfiler(device)
    with prof.stage("ldpc_decode", items=B, unit="cw"):
        bits, ok, _ = ldpc_decode(...)
    print(prof.report())

    with xla_trace("out/trace"):       # Chrome trace, CPU + CUDA
        step(x)

On a CUDA device a stage is timed by a pair of torch.cuda.Events recorded
on the current stream, so a stage costs no synchronisation: the times are
resolved when they are read (stats, rate, report), with one synchronize
for all stages pending. A stage's time is then the span between its two
events on the stream (its own kernels, and any gap in which the stream
waited for the host), not the host's wall time up to a synchronise. On
the CPU a stage is timed by perf_counter.
"""
from __future__ import annotations

import contextlib
import pathlib
import time
import warnings
from collections import defaultdict
from dataclasses import dataclass

import torch

from python_5gtoolbox_tpu_torch import resolve_device


@dataclass
class _StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0
    unit: str = "items"


class StageProfiler:
    """Accumulates time and item counts per named pipeline stage on one
    device (None: the card)."""

    # stages that run once per slot: many of them on the card is a path
    # that the slot-batched RX serves in one call
    PER_SLOT_STAGES = ("rx_process[", "channel_est")

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._stats = defaultdict(_StageStats)
        self._pending = []      # (stats, start event, end event)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0, unit: str = "items"):
        s = self._stats[name]
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self._pending.append((s, start, end))
                s.calls += 1
                s.items += items
                s.unit = unit
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s.calls += 1
            s.seconds += time.perf_counter() - t0
            s.items += items
            s.unit = unit

    @property
    def stats(self) -> dict:
        """name -> _StageStats, every pending event pair resolved."""
        if self._pending:
            torch.cuda.synchronize(self.device)
            for s, start, end in self._pending:
                s.seconds += start.elapsed_time(end) / 1e3
            self._pending.clear()
        return self._stats

    def rate(self, name: str) -> float:
        s = self.stats[name]
        return s.items / s.seconds if s.seconds else 0.0

    def report(self) -> str:
        lines = [f"{'stage':24s} {'calls':>6s} {'total_s':>9s} "
                 f"{'per_call_ms':>12s} {'throughput':>18s}"]
        for name, s in sorted(self.stats.items()):
            thr = (f"{self.rate(name):,.0f} {s.unit}/s" if s.items
                   else "-")
            lines.append(
                f"{name:24s} {s.calls:6d} {s.seconds:9.3f} "
                f"{1e3 * s.seconds / max(s.calls, 1):12.2f} {thr:>18s}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._stats.clear()
        self._pending.clear()

    def check_dispatch_routing(self, limit: int = 32,
                               backend: str | None = None) -> list:
        """Warn when per-slot stages ran more than `limit` times on an
        accelerator (backend: default the profiler's device type; "cpu"
        is never flagged). Returns [(stage, calls), ...] and warns once
        for each."""
        backend = self.device.type if backend is None else backend
        if backend == "cpu":
            return []
        offenders = [(n, s.calls) for n, s in self._stats.items()
                     if any(n.startswith(p) for p in self.PER_SLOT_STAGES)
                     and s.calls > limit]
        for name, calls in offenders:
            warnings.warn(
                f"per-slot stage '{name}' dispatched {calls} times on "
                f"the '{backend}' backend (> {limit}); the slot-batched RX "
                f"(rx_process_batch) serves this path in one call",
                RuntimeWarning, stacklevel=2)
        return offenders


@contextlib.contextmanager
def xla_trace(logdir: str):
    """torch.profiler scope over CPU and CUDA activities (CUDA where
    torch sees a card); writes a Chrome trace, trace.json, under logdir
    (view it in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))
