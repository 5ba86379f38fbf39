"""Per-stage timing with throughput counters, nested spans and counters,
and a profiler trace scope.

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

Code beneath a stage reaches its profiler without being handed it: a
stage makes its profiler the active one (a context variable, restored on
exit), span(name) records a nested stage into the active profiler and
count(name, value) adds to one of its counters. With no profiler active,
span returns one shared no-op context and count does nothing, so code
that is not being profiled records nothing. Every stage and span also
opens a torch.profiler.record_function range of its name while a torch
profiler is running, which puts the program's spans on the device
trace's timeline.
"""
from __future__ import annotations

import contextlib
import contextvars
import pathlib
import time
import warnings
from collections import defaultdict
from dataclasses import dataclass

import torch

from python_5gtoolbox_tpu_torch import resolve_device

# (profiler, name of the innermost open stage or span) while one is open
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "active_stage_profiler", default=None)
_OFF = contextlib.nullcontext()


@dataclass
class _StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0
    unit: str = "items"
    parent: str | None = None     # enclosing stage or span (latest call)


def _trace_range(name: str):
    """A record_function range while a torch profiler runs, else the
    no-op context (the check costs far less than an idle range)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class StageProfiler:
    """Accumulates time and item counts per named pipeline stage on one
    device (None: the card), and named counters."""

    # stages that run once per slot: many of them on the card is a path
    # that the slot-batched RX serves in one call
    PER_SLOT_STAGES = ("rx_process[", "channel_est")

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._stats = defaultdict(_StageStats)
        self._pending = []      # (stats, start event, end event)
        self._counters: dict = {}
        self._pending_counts = []   # (name, 0-dim device tensor)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0, unit: str = "items"):
        s = self._stats[name]
        outer = _ACTIVE.get()
        s.parent = outer[1] if outer is not None and outer[0] is self \
            else None
        token = _ACTIVE.set((self, name))
        cuda = self.device.type == "cuda"
        try:
            with _trace_range(name):
                if cuda:
                    stream = torch.cuda.current_stream(self.device)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                else:
                    t0 = time.perf_counter()
                try:
                    yield
                finally:
                    if cuda:
                        end = torch.cuda.Event(enable_timing=True)
                        end.record(stream)
                        self._pending.append((s, start, end))
                    else:
                        s.seconds += time.perf_counter() - t0
                    s.calls += 1
                    s.items += items
                    s.unit = unit
        finally:
            _ACTIVE.reset(token)

    def count(self, name: str, value) -> None:
        """Adds value (a number, or a tensor whose sum is taken on its
        device and read with the stages' events) to counter name."""
        if isinstance(value, torch.Tensor):
            self._pending_counts.append((name, value.sum()))
        else:
            self._counters[name] = self._counters.get(name, 0) + value

    def _resolve(self) -> None:
        if self._pending:
            torch.cuda.synchronize(self.device)
            for s, start, end in self._pending:
                s.seconds += start.elapsed_time(end) / 1e3
            self._pending.clear()
        if self._pending_counts:
            by_name = defaultdict(list)
            for name, t in self._pending_counts:
                by_name[name].append(t)
            for name, ts in by_name.items():
                self._counters[name] = self._counters.get(name, 0) \
                    + torch.stack(ts).sum().item()
            self._pending_counts.clear()

    @property
    def stats(self) -> dict:
        """name -> _StageStats, every pending event pair resolved."""
        self._resolve()
        return self._stats

    @property
    def counters(self) -> dict:
        """name -> total, every pending device sum resolved."""
        self._resolve()
        return self._counters

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
        if self.counters:
            lines.append(f"{'counter':24s} {'total':>18s}")
            for name, v in sorted(self.counters.items()):
                lines.append(f"{name:24s} {v:18,}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._stats.clear()
        self._pending.clear()
        self._counters.clear()
        self._pending_counts.clear()

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


def active() -> StageProfiler | None:
    """The profiler of the innermost open stage or span, if any."""
    outer = _ACTIVE.get()
    return None if outer is None else outer[0]


def span(name: str, items: float = 0.0, unit: str = "items"):
    """A stage of the active profiler nested in the open one (its stats
    name that one as parent), or, with no profiler active, one shared
    no-op context."""
    outer = _ACTIVE.get()
    if outer is None:
        return _OFF
    return outer[0].stage(name, items, unit)


def count(name: str, value) -> None:
    """StageProfiler.count on the active profiler; nothing without one."""
    outer = _ACTIVE.get()
    if outer is not None:
        outer[0].count(name, value)


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
