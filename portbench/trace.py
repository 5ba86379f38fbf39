"""Reading a torch.profiler trace of a traced sub-window.

device_events gives the operations that ran on the card (kernels,
copies, sets) as (name, start_us, end_us); busy_seconds the union of
their intervals (the share of the sub-window in which something ran on
the device, as sim/profile_sweep.py reads a sweep's busy share, with
overlaps counted once); breakdown the device operations that took the
most time and the idle gaps of the card by what the host was doing
then: the benchmark's stage span (stage:<name>, a record_function
around each stage of the point) and the innermost host operation under
it ("python" where none was running).
"""
from __future__ import annotations

import re
from collections import defaultdict

import torch

STAGE_PREFIX = "stage:"


def _short(name: str) -> str:
    """A kernel's name without template and argument lists, at most 64
    characters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:64]


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of every operation that ran on the
    device; the device-side copies of the host's record_function spans
    (user annotations, such as the stage spans) are not operations."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(STAGE_PREFIX)),
                  key=lambda x: x[1])


def _merged(events) -> list[tuple[float, float]]:
    out: list = []
    for _, a, b in events:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def busy_seconds(events) -> float:
    return sum(b - a for a, b in _merged(events)) / 1e6


def _host_events(prof):
    """Host operations of the thread that ran the stage spans, sorted by
    start: (start_us, end_us, name, is_stage)."""
    cpu = torch.autograd.DeviceType.CPU
    evs = [e for e in prof.events() if e.device_type == cpu]
    threads = {e.thread for e in evs if e.name.startswith(STAGE_PREFIX)}
    rows = [(e.time_range.start, e.time_range.end, e.name,
             e.name.startswith(STAGE_PREFIX))
            for e in evs if not threads or e.thread in threads]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def idle_gaps(prof, events, t0_us: float, t1_us: float) -> dict:
    """Idle seconds of the card between t0_us and t1_us, by
    '<stage>/<innermost host operation>' at each gap's middle."""
    gaps, cur = [], t0_us
    for a, b in _merged(events):
        if a > cur:
            gaps.append((cur, min(a, t1_us)))
        cur = max(cur, b)
    if cur < t1_us:
        gaps.append((cur, t1_us))
    host = _host_events(prof)
    out: dict = defaultdict(float)
    stack: list = []
    i = 0
    for a, b in sorted(gaps):
        if b <= a:
            continue
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        live = [h for h in stack if h[0] <= mid <= h[1]]
        stage = next((h[2][len(STAGE_PREFIX):] for h in reversed(live)
                      if h[3]), "outside")
        op = next((h[2] for h in reversed(live) if not h[3]), "python")
        out[f"{stage}/{op}"] += (b - a) / 1e6
    return dict(out)


def breakdown(prof, events, t0_us: float, t1_us: float, top: int = 10
              ) -> dict:
    """{"device_ops": [[name, seconds], ...], "idle_gaps": [[name,
    seconds], ...]}, each the top entries by seconds."""
    ops: dict = defaultdict(float)
    for name, a, b in events:
        ops[_short(name)] += (b - a) / 1e6
    gaps = idle_gaps(prof, events, t0_us, t1_us)
    return dict(
        device_ops=[[k, v] for k, v in sorted(ops.items(),
                                             key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(),
                                            key=lambda kv: -kv[1])[:top]])
