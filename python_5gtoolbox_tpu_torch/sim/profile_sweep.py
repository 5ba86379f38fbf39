"""Where the link-level PDSCH or PUSCH sweep, or a test model, spends its
time on the card.

    python -m python_5gtoolbox_tpu_torch.sim.profile_sweep \
        [--rate-mhz 245.76] [--small-alloc | --pusch | --testmodel TM]
        [--per-slot] [TRACE.json]

Runs the bench configuration (pdsch_throughput.bench_link_level_config,
6 SNR points x 20 slots; with --small-alloc its small allocation,
small_alloc_link_level_config; with --pusch the transform-precoded UL
sweep, pusch_throughput.bench_link_level_pusch_tp_config, at the carrier
rate) twice after one warm run, at the carrier rate or, with --rate-mhz,
with the waveform, the channel and the RX front end at that sample rate,
and prints one JSON line each:
  * "stages": time per stage of the sweep (tx_waveform, channel,
    rx_lowphy, rx_batch[MMSE-IRC]; with --per-slot the reference-shaped
    per-slot RX in place of the batched one: channel_est and
    rx_process[MMSE-IRC], charged slot by slot) on the StageProfiler's
    CUDA events: the span between each stage's two events on the stream,
    with no synchronisation between stages; the spans nested in them
    (tx.sch_encode, tx.symbols, tx.grid, low_phy, channel_filter, rx.ce,
    rx.gather, rx.equalize, rx.ratematch, rx.ldpc) are listed beside
    them, and "share" is of the top-level stages' sum;
  * "kernels": torch.profiler device time per kernel over one sweep
    without stage synchronisation, the sweep's wall time and the share
    of it the device was busy; with a path argument the Chrome trace of
    that sweep is written there; "port_kernels" lists the hand-written
    kernels among them, whatever their rank; "host_top" the host-side
    operations and runtime calls with the most self CPU time.
With --testmodel (NR-FR1-TM1.1 ... NR-FR1-TM3.1a) it runs that test
model at full width (scs 30 / BW 100 / TDD, 40 slots at 122.88 Msps,
payloads from seed 0) through gen_dl_waveform in place of the sweep; its
"stages", together the whole run, are the channel objects' construction
(channel_list) and gen_dl_waveform's own:
slot_grids (every channel's process, slot by slot), low_phy (OFDM and
slot phase) and channel_filter.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from python_5gtoolbox_tpu_torch.sim import gen_nr_testmodel as tm_script
from python_5gtoolbox_tpu_torch.sim import pdsch_throughput as sim
from python_5gtoolbox_tpu_torch.sim import pusch_throughput as usim
from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler
from python_5gtoolbox_tpu_torch.waveform import dl as dl_wf

SNRS = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
N_SLOTS = 20
# __global__ function names of csrc/*.cu (the LDPC kernels, templates in
# csrc/ldpc_common.cuh shared by ldpc_minsum and ldpc_minsum_packed, by
# their demangled prefix)
PORT_KERNELS = ("banded_fir_kernel", "ldpc::decode_kernel",
                "ldpc::decode_warp_kernel", "fir_up2_fused_kernel",
                "fir_up2_fused_symbols_kernel",
                "duc_from_spec_kernel", "ml2_maxlog_kernel",
                "fading_channel_kernel")


def _run_sweep(rate_mhz=None, prof=None, small_alloc=False, pusch=False,
               per_slot=False):
    if pusch:
        carrier, ch_cfg, chan, ce, ldpc = \
            usim.bench_link_level_pusch_tp_config()
        run = usim.run_pusch_throughput
    else:
        carrier, ch_cfg, chan, ce, ldpc = (
            sim.small_alloc_link_level_config() if small_alloc
            else sim.bench_link_level_config())
        run = sim.run_pdsch_throughput
    if rate_mhz is not None:
        carrier["samplerate_in_mhz"] = rate_mhz
    return run(carrier, ch_cfg, chan, SNRS, ["MMSE-IRC"], n_slots=N_SLOTS,
               ce_config=ce, ldpc_config=ldpc, seed=3, device="cuda",
               prof=prof, use_batch=not per_slot)


def _run_testmodel(tm: str, prof=None):
    """The test model at full width, its stages charged to prof."""
    with contextlib.nullcontext() if prof is None \
            else prof.stage("channel_list"):
        wf, carrier, lists = tm_script.tm_channel_lists(
            tm, tm_script.FULL_WIDTH, device="cuda")
    return dl_wf.gen_dl_waveform(wf, carrier, *lists, prof=prof)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rate-mhz", type=float, default=None,
                    help="waveform sample rate (default: the carrier rate)")
    ap.add_argument("--small-alloc", action="store_true",
                    help="MCS 0 on 12 RBs (Zc 80) in place of the bench "
                         "allocation")
    ap.add_argument("--pusch", action="store_true",
                    help="the transform-precoded UL sweep (carrier rate "
                         "only)")
    ap.add_argument("--testmodel", default=None,
                    help="a test model at full width in place of the sweep")
    ap.add_argument("--per-slot", action="store_true",
                    help="the per-slot RX (channel_est, rx_process) in "
                         "place of the slot-batched one")
    ap.add_argument("trace", nargs="?", help="write the Chrome trace here")
    args = ap.parse_args()
    if (args.pusch or args.testmodel) and (args.rate_mhz is not None
                                           or args.small_alloc):
        ap.error("--pusch and --testmodel run at the carrier rate on their "
                 "own allocation")
    if args.per_slot and args.testmodel:
        ap.error("--per-slot profiles a sweep, not a test model")
    rate, small, pusch = args.rate_mhz, args.small_alloc, args.pusch
    tm, per_slot = args.testmodel, args.per_slot
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(prof=None):
        if tm:
            return _run_testmodel(tm, prof)
        return _run_sweep(rate, prof, small, pusch, per_slot)
    run()                                                # warm
    timer = StageProfiler("cuda")
    t0 = time.perf_counter()
    run(timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seconds = {k: s.seconds for k, s in timer.stats.items()}
    total = sum(s.seconds for s in timer.stats.values() if s.parent is None)
    print(json.dumps(dict(
        phase="stages", rate_mhz=rate, small_alloc=small, pusch=pusch,
        testmodel=tm, per_slot=per_slot, wall_s=wall, seconds=seconds,
        share={k: v / total for k, v in seconds.items()})), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host = [], []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): operator
        # events would count their kernels' time a second time
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host.append(dict(name=evt.key[:90], calls=evt.count,
                             self_cpu_ms=evt.self_cpu_time_total / 1e3))
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append(dict(name=evt.key[:90], calls=evt.count,
                             device_ms=dev_us / 1e3))
    rows.sort(key=lambda r: -r["device_ms"])
    own = [r for r in rows if any(k in r["name"] for k in PORT_KERNELS)]
    busy = sum(r["device_ms"] for r in rows) / 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    host.sort(key=lambda r: -r["self_cpu_ms"])
    print(json.dumps(dict(
        phase="kernels", rate_mhz=rate, small_alloc=small, pusch=pusch,
        testmodel=tm, per_slot=per_slot, wall_s=wall,
        device_busy_s=busy,
        device_busy_share=busy / wall,
        launches=sum(r["calls"] for r in rows), n_kernel_names=len(rows),
        top=rows[:20], port_kernels=own, host_top=host[:15])), flush=True)


if __name__ == "__main__":
    main()
