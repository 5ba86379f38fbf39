"""One run of one link-level cell of the port, and its result line.

A cell is a closed loop with one client, a user's SNR sweep: point i
(i = 1, 2, ...) runs the port's sweep entry (sim.pdsch_throughput.
run_pdsch_throughput or sim.pusch_throughput.run_pusch_throughput, with
the cell's use_batch) on one SNR point of the cell's list, cycled, with
seed --seed + 7919 * i, as the port's run_sweep numbers its points. The
transport blocks are the benchmark's: drawn on the device from the
point's seed and handed in as the point's state (the layout of
interop.state_from_numpy); the fading taps and the noise are the port's
own draws. A point ends when its CRC flags are on the host, and the next
starts then.

Set-up (process start to the first timed point) loads the port, builds
or loads its kernels (build/ in the checkout) and runs point 0, which
warms every shape the window uses. The window then runs points for
--seconds seconds of wall time, and at least up to the last point drawn
for the comparison; the point running when they are up finishes and
counts with its time. sim_slots_per_s is the slots of all points over
all that time.

With --trace 1 the first points of the window (the traffic's
trace_points) run under torch.profiler, which gives the device's busy
share, its operations and the card's idle gaps; the rest of the window
runs under the benchmark's stage timer (the port's StageProfiler, each
stage also a record_function span), which gives the per-layer times and
the program's counters (read once the window has closed).

After the window the probe's copies of a few points drawn from the seed
(probe.py) are compared with the configuration's plain reference
(cell.reference, spec.reference), once the peak memory has been read and
the program's state freed.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import importlib
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from portbench import compare, probe as probe_mod, trace as trace_mod
from portbench.reference.frozen.phy import tbsize as tbs_mod
from portbench.reference.frozen.utils.numerology import (carrier_prb_size,
                                                         fft_size,
                                                         slots_per_frame)
from portbench.spec import Cell

BANNED = ("jax", "jaxlib", "flax", "python_5gtoolbox_tpu")
PORT = probe_mod.PORT
SEED_STEP = 7919            # the port's run_sweep: seed + 7919 * point


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def card() -> str:
    """'<name>, <power limit>' of the card, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


class _Stages:
    """The port's StageProfiler, each stage also a record_function span
    (stage:<name>) for the trace."""

    def __init__(self, device):
        from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler
        self.timer = StageProfiler(device)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0, unit: str = "items"):
        with torch.profiler.record_function(trace_mod.STAGE_PREFIX + name), \
                self.timer.stage(name, items, unit):
            yield


class Program:
    """The cell's system under test: the port's sweep entry, one SNR
    point per call."""

    def __init__(self, cell: Cell, device):
        cfg, traffic = cell.config, cell.traffic
        self.dev = torch.device(device)
        self.cfg, self.traffic = cfg, traffic
        self.carrier = copy.deepcopy(cfg["carrier"])
        self.ch_cfg = copy.deepcopy(cfg["channel_config"])
        chan = importlib.import_module(f"{PORT}.models.channel")
        ch = dict(traffic["channel"])
        if "Rspat_config" in ch:
            corr, pol, direction, params = ch["Rspat_config"]
            ch["Rspat_config"] = (corr, pol, direction, tuple(params))
        self.chan_cfg = chan.gen_channel_model_config(
            Nt=self.carrier["num_of_ant"], Nr=self.carrier["Nr"], **ch)
        if cfg["link"] == "DL":
            self.entry = importlib.import_module(
                f"{PORT}.sim.pdsch_throughput").run_pdsch_throughput
            self.tbsize = tbs_mod.gen_tbsize(self.ch_cfg)[0]
        else:
            self.entry = importlib.import_module(
                f"{PORT}.sim.pusch_throughput").run_pusch_throughput
            self.tbsize = tbs_mod.ulsch_tbsize(self.ch_cfg)[0]
        n = traffic["slots_per_point"]
        spf = slots_per_frame(self.carrier["scs"])
        self.n_alloc = sum(
            (i % spf) % self.ch_cfg["period_in_slot"]
            in self.ch_cfg["allocated_slots"] for i in range(n))

    def seed(self, base: int, i: int) -> int:
        return base + SEED_STEP * i

    def snr(self, i: int) -> float:
        snrs = self.traffic["snr_db"]
        return float(snrs[i % len(snrs)])

    def trblks(self, seed: int) -> torch.Tensor:
        """The (allocated slots, TBSize) blocks of the point with this
        seed, drawn on the device."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed((2 * seed + 1) % 2 ** 63)
        return torch.randint(0, 2, (self.n_alloc, self.tbsize),
                             generator=gen, device=self.dev,
                             dtype=torch.int8)

    def point(self, seed: int, snr: float, trblks, prof=None) -> dict:
        t = self.traffic
        state = dict(trblks=trblks, taps=None, noise=None)
        return self.entry(
            self.carrier, self.ch_cfg, self.chan_cfg, [snr], t["equalizers"],
            n_slots=t["slots_per_point"], ce_config=self.cfg["ce"],
            ldpc_config=self.cfg["ldpc"], seed=seed, prof=prof,
            use_batch=t["use_batch"], device=self.dev, states=[state])

    def fir_launches_per_point(self) -> list[tuple]:
        """The banded_fir launches of one point at the carrier rate:
        (planes, samples, taps, mode) of the TX and of the RX FIR."""
        from portbench.reference.frozen.ops.filters import fir_coeff
        c = self.carrier
        nfft = fft_size(carrier_prb_size(c["scs"], c["BW"]))
        t = self.traffic["slots_per_point"] * 15 * nfft
        taps = len(fir_coeff(c["scs"], c["BW"]))
        return [(2 * c["num_of_ant"], t, taps, "same"),
                (2 * c["Nr"], t, taps, "same")]


@dataclass
class Run:
    """What a run measured, for the per-layer readers: the stage timer's
    stage seconds and counters over the stage_slots of the staged
    sub-window, and the traced sub-window's device events."""
    stages: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    stage_slots: int = 0
    device_events: list = field(default_factory=list)
    busy_s: float = 0.0
    trace_window_s: float = 0.0
    trace_slots: int = 0
    trace_points: int = 0
    fir_shapes: list = field(default_factory=list)

    def stage_ms_per_slot(self, name: str):
        secs = [s for k, s in self.stages.items()
                if k == name or k.startswith(name + "[")]
        if not secs or not self.stage_slots:
            return None
        return 1e3 * sum(secs) / self.stage_slots

    def counter_per_slot(self, name: str):
        if name not in self.counters or not self.stage_slots:
            return None
        return self.counters[name] / self.stage_slots

    def device_seconds(self, part: str):
        secs = [b - a for n, a, b in self.device_events if part in n]
        return sum(secs) / 1e6 if secs else None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=sys.stderr) -> dict:
    """Set-up, window and comparison of one run -> the result dict
    (without the printing)."""
    t_enter = time.perf_counter()
    dev = torch.device(device)
    traffic = cell.traffic
    check = traffic["check"]
    sample = set(random.Random(seed).sample(
        range(1, check["among_first"] + 1), check["points"]))
    probe = probe_mod.Probe()
    probe.install()
    program = Program(cell, dev)
    sink = open(os.devnull, "w")
    run = Run(fir_shapes=program.fir_launches_per_point())
    try:
        t_warm = time.perf_counter()
        with contextlib.redirect_stdout(sink):
            s0 = program.seed(seed, 0)
            program.point(s0, program.snr(0), program.trblks(s0))
            _sync(dev)
        setup_s = time.perf_counter() - t_start
        print(f"portbench: set-up {setup_s:.3f} s: imports "
              f"{t_enter - t_start:.3f} s, the port's objects "
              f"{t_warm - t_enter:.3f} s, the warm point "
              f"{time.perf_counter() - t_warm:.3f} s", file=log)

        kept, points, slots, point_s = {}, 0, 0, []
        stages = _Stages(dev) if trace else None
        prof = None
        t0 = time.perf_counter()
        t_trace = None
        with contextlib.redirect_stdout(sink):
            while True:
                i = points + 1
                if trace and points == 0:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.__enter__()
                    t_trace = time.perf_counter()
                si = program.seed(seed, i)
                trb = program.trblks(si)
                if i in sample:
                    probe.arm(i)
                    kept[i] = (si, program.snr(i), trb)
                t_point = time.perf_counter()
                program.point(si, program.snr(i), trb, prof=stages)
                point_s.append(time.perf_counter() - t_point)
                probe.disarm()
                points += 1
                slots += traffic["slots_per_point"]
                if prof is not None and points == traffic["trace_points"]:
                    _sync(dev)
                    run.trace_window_s = time.perf_counter() - t_trace
                    prof.__exit__(None, None, None)
                    run.trace_points = points
                    run.trace_slots = slots
                    stages = _Stages(dev)
                    prof_done, prof = prof, None
                    slots_at_stage = slots
                if time.perf_counter() - t0 >= seconds \
                        and points >= max(sample) and (
                            not trace or (run.trace_points
                                          and slots > slots_at_stage)):
                    break
            _sync(dev)
        window_s = time.perf_counter() - t0
        rate = slots / window_s
        q = sorted(point_s)
        print(f"portbench: {points} points, seconds a point: min {q[0]:.4f} "
              f"median {q[len(q) // 2]:.4f} max {q[-1]:.4f}", file=log)
        if trace:
            run.stages = {k: s.seconds for k, s in stages.timer.stats.items()}
            run.counters = dict(stages.timer.counters)
            run.stage_slots = slots - slots_at_stage
            if not run.stage_slots:
                raise RuntimeError("the window ended inside the traced "
                                   "sub-window: no stage times")
            evs = trace_mod.device_events(prof_done)
            run.device_events = evs
            run.busy_s = trace_mod.busy_seconds(evs)
            host = [e for e in prof_done.events()
                    if e.device_type == torch.autograd.DeviceType.CPU]
            t_lo = min([e.time_range.start for e in host]
                       + [a for _, a, _ in evs])
            t_hi = max([e.time_range.end for e in host]
                       + [b for _, _, b in evs])
            breakdown = trace_mod.breakdown(prof_done, evs, t_lo, t_hi)
            del prof_done
        found = banned_modules()
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    finally:
        probe.uninstall()
        sink.close()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per_point = []
    for i, (si, snr, trb) in sorted(kept.items()):
        got = probe.outputs(i)
        ref = cell.reference.point(copy.deepcopy(cell.config), traffic, snr,
                                   si, trb, dev)
        per_point.append(compare.point_numbers(got, ref, trb))
        del got, ref
        probe.taken.pop(i)
    numbers = compare.combine(per_point)
    correct, rows = compare.judge(numbers, cell.limits)
    failed = sum(not compare.judge(n, cell.limits)[0] for n in per_point)
    if not per_point:
        correct, failed = False, 1
    out = dict(correct=correct, attempted=points, failed=failed,
               banned=found, setup_s=setup_s, rate=rate, window_s=window_s,
               peak=peak, rows=rows, run=run)
    if trace:
        out["breakdown"] = breakdown
    return out
