"""Time the filter kernels at the shapes their main paths give them, on
the card.

    python python_5gtoolbox_tpu_torch/sim/time_filter_kernels.py [LABEL]
    python python_5gtoolbox_tpu_torch/sim/time_filter_kernels.py --tune
    python python_5gtoolbox_tpu_torch/sim/time_filter_kernels.py --peak

Run as a file, it times whichever python_5gtoolbox_tpu_torch comes first
on PYTHONPATH, so one call can time two trees of the repository in turns
(PYTHONPATH=old python .../time_filter_kernels.py old). Shapes:

* banded_fir at the six stages of the 245.76 Msps sweep (BW 20, 20 slots,
  2 TX / 4 RX antennas as real planes: DUC up2 4x614400 and 4x1228800, DDC
  down2 8x2457600, 8x1228800 and 8x614400, RX FIR 'same' 8x307200, 71
  taps), the TX FIR 'same' 4x307200 (71 taps) and the 287-tap 'same'
  4x307200;
* duc_from_spec at the waveform bench's width (scs 30 / BW 100, 2
  antennas, 64 slots: 4x64x14x4096, 287 + 55 taps) and at the 245.76
  sweep's shape (BW 20, 2 antennas, 20 slots: 4x20x14x1024, 71 + 55);
  where the tree has a cluster planner, also with each cluster size of
  CLUSTERS forced;
* fir_up2_fused at the timing-error waveform's rows (FUSED_SHAPES: BW 20
  and BW 100 at 20 slots, 4x307200 with 71 + 55 taps and 4x1228800 with
  287 + 55; 4x3932160 with 287 + 55, 64 slots; one slot at BW 20) and
  fir_up2_fused_symbols at the three carriers below nfft 1024
  (SYMBOL_SHAPES: scs 15 / BW 5, scs 30 / BW 10 and scs 30 / BW 5, 2
  antennas, 20 slots and 1 slot), which share the DUC tile routine.

--tune times banded_fir at the same shapes with each forced pair of ring
depth (stages) and tiles per block (TUNE_STAGES x TUNE_TILES); the plan's
rule (ops/filters.py:fir_plan, FIR_RING_OUTPUTS_PER_SM) comes from it. It
times fir_up2_fused with each forced number of outputs per thread
(FUSED_PERS) and fir_up2_fused_symbols with each forced number of
symbols per block (FUSED_GROUPS); fused_plan's and fused_symbols_plan's
defaults come from it.

--peak measures the yardstick of the operation-bound rows: the card's
FP32 FMA rate (sim/ffma_peak.cu, built with nvcc into build/kernels/),
then fir_up2_fused at 4x3932160 with 287 + 55 taps, each run back to
back for a few seconds while nvidia-smi samples the SM clock and the
power draw; one JSON line each (TFLOP/s or device ms, the clocks and
powers seen, the kernel's share of the measured FMA rate).

Per shape one JSON line: device_ms (device time per call with the
launches back to back, sim/time_ldpc_kernels.py:device_ms), call_ms (CUDA
events around consecutive calls, host time included), host_ms (the
wrapper's own time per call on the host: the least of five runs of
consecutive calls, timed on the host's clock without synchronising), the
largest
difference from the plain version, the card's name and power limit and,
where the tree has them, the launch plan (fir_plan, duc_plan). Inputs
come from a fixed seed. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import pathlib
import subprocess
import sys
import threading
import time

import torch

CLUSTERS = (1, 4, 8, 16)
TUNE_STAGES = (1, 2)
TUNE_TILES = (1, 2, 4)
# (planes, t, scs, bw) and (scs, bw, antennas, slots)
FUSED_SHAPES = ((4, 307200, 30, 20), (4, 1228800, 30, 100),
                (4, 3932160, 30, 100), (2, 15360, 30, 20))
# --tune also forces each choice of fused_plan at BW 20's row length with
# the FIR lengths between 71 and 287 taps (87, 143, 153)
TUNE_FUSED_SHAPES = FUSED_SHAPES + ((4, 307200, 30, 15), (4, 307200, 30, 30),
                                    (4, 307200, 15, 15))
SYMBOL_SHAPES = ((15, 5, 2, 20), (30, 10, 2, 20), (30, 5, 2, 20),
                 (15, 5, 2, 1), (30, 5, 2, 1))


def _fir_shapes(filters):
    """(planes, t_in, taps, mode) of the banded_fir stages timed."""
    fir20, fir100 = filters.fir_coeff(30, 20), filters.fir_coeff(30, 100)
    hb = filters.halfband_coeff()
    return [(4, 614400, hb, "up2"), (4, 1228800, hb, "up2"),
            (8, 2457600, hb, "down2"), (8, 1228800, hb, "down2"),
            (8, 614400, hb, "down2"), (8, 307200, fir20, "same"),
            (4, 307200, fir20, "same"), (4, 307200, fir100, "same")]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def host_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Host time per call of fn(): the calls only enqueue launches, so the
    host's clock around reps of them, with no synchronisation in between,
    measures the wrapper; the least of `rounds` runs."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e3 * best / reps


def _plan_dict(plan) -> dict:
    if plan is None:
        return {}
    keep = ("tiles_per_block", "stages", "blocks", "vec", "kp", "d",
            "cluster", "group", "win")
    out = {k: v for k, v in dataclasses.asdict(plan).items() if k in keep}
    for k in ("blocks", "idfts_per_symbol", "smem_bytes"):
        if hasattr(plan, k):
            out[k] = getattr(plan, k)
    gm = getattr(plan, "geometry", None)
    if gm is not None and hasattr(gm, "per"):
        out.update(per=gm.per, lead=gm.lead, nz_tile=gm.nz_tile)
    return out


def main(label: str = "") -> None:
    from python_5gtoolbox_tpu_torch.ops import filters, ofdm
    from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import (call_ms,
                                                                 device_ms)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    smi = _smi()
    fir_plan = getattr(filters, "fir_plan", None)
    duc_plan = getattr(filters, "duc_plan", None)

    def emit(kernel, shape, fn, plain, plan=None, reps=50, **extra):
        got = fn()
        err = (got - plain()).abs().max().item()
        row = dict(tree=label, kernel=kernel, shape=list(shape),
                   device_ms=device_ms(fn, reps), call_ms=call_ms(fn, reps),
                   host_ms=host_ms(fn, reps),
                   max_abs_err=err, plan=_plan_dict(plan), card=smi, **extra)
        print(json.dumps(row), flush=True)

    hb = filters.halfband_coeff()
    for planes, t_in, taps, mode in _fir_shapes(filters):
        x = torch.randn((planes, t_in), generator=gen, device=dev)
        plan = (fir_plan(len(taps), mode, t_in, planes) if fir_plan
                else None)
        emit("banded_fir", x.shape,
             lambda: filters.banded_fir(x, taps, mode),
             lambda: filters.banded_fir_plain(x, taps, mode), plan,
             mode=mode, taps=len(taps))

    fc = 3_500_000_000
    for bw, n_slots in ((100, 64), (20, 20)):
        n_sc = 12 * ofdm.num.carrier_prb_size(30, bw)
        fd = torch.complex(
            torch.randn((2, n_slots, 14, n_sc), generator=gen, device=dev),
            torch.randn((2, n_slots, 14, n_sc), generator=gen, device=dev))
        spec = ofdm.tx_spec_planes(fd, 30, bw, fc)
        nfft = spec.shape[-1]
        cps, pc = ofdm._cp_table(30, nfft), ofdm._phase_comp(30, nfft, fc)
        fir = filters.fir_coeff(30, bw)
        ref = torch.cat(filters.duc_from_spec_planes_plain(spec, cps, fir,
                                                           hb, pc))
        plans = [None]
        if duc_plan is not None:
            plans = [duc_plan(2, n_slots, nfft, len(fir), len(hb), cps)]
            plans += [duc_plan(2, n_slots, nfft, len(fir), len(hb), cps, k)
                      for k in CLUSTERS if k != plans[0].cluster]
        for plan in plans:
            kw = {} if plan is None else dict(plan=plan)
            emit("duc_from_spec", spec.shape,
                 lambda: filters._duc_from_spec(spec, cps, fir, hb, pc,
                                                **kw),
                 lambda: ref, plan, reps=20, taps=len(fir),
                 default_plan=plan is plans[0])
        del ref

    fused_plan = getattr(filters, "fused_plan", None)
    for planes, t, scs, bw in FUSED_SHAPES:
        x = torch.randn((planes, t), generator=gen, device=dev)
        fir = filters.fir_coeff(scs, bw)
        plan = (fused_plan(planes, t, len(fir), len(hb)) if fused_plan
                else None)
        emit("fir_up2_fused", x.shape,
             lambda: filters.fir_up2_fused_planes(x, fir, hb),
             lambda: filters.fir_up2_fused_plain(x, fir, hb), plan, reps=20,
             taps=len(fir))
    symbols_plan = getattr(filters, "fused_symbols_plan", None)
    for scs, bw, nant, n_slots in SYMBOL_SHAPES:
        symp, cps, fir = _symbol_planes(ofdm, filters, gen, scs, bw, nant,
                                        n_slots)
        plan = (symbols_plan(2 * nant, n_slots, symp.shape[-1], len(fir),
                             len(hb), cps) if symbols_plan else None)
        emit("fir_up2_fused_symbols", symp.shape,
             lambda: filters.fir_up2_fused_symbols(symp, cps, fir, hb),
             lambda: filters.fir_up2_fused_symbols_plain(symp, cps, fir, hb),
             plan, taps=len(fir))


def _symbol_planes(ofdm, filters, gen, scs, bw, nant, n_slots):
    """IFFT output planes of a random grid, the CP table and the FIR."""
    n_sc = 12 * ofdm.num.carrier_prb_size(scs, bw)
    dev = torch.device("cuda")
    fd = torch.complex(
        torch.randn((nant, n_slots, 14, n_sc), generator=gen, device=dev),
        torch.randn((nant, n_slots, 14, n_sc), generator=gen, device=dev))
    symp = ofdm.tx_low_phy_sym_planes(fd, scs, bw, 3_500_000_000)
    cps = tuple(int(c) for c in ofdm._cp_table(scs, symp.shape[-1]))
    return symp, cps, filters.fir_coeff(scs, bw)


def tune() -> None:
    from python_5gtoolbox_tpu_torch.ops import filters, ofdm
    from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import device_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    smi = _smi()
    hb = filters.halfband_coeff()

    def emit(kernel, shape, run, ref, plan, default, reps=50, **extra):
        err = (run() - ref).abs().max().item()
        print(json.dumps(dict(
            kernel=kernel, shape=list(shape), plan=_plan_dict(plan),
            device_ms=device_ms(run, reps), max_abs_err=err,
            default=plan == default, card=smi, **extra)), flush=True)

    for planes, t_in, taps, mode in _fir_shapes(filters):
        x = torch.randn((planes, t_in), generator=gen, device=dev)
        ref = filters.banded_fir_plain(x, taps, mode)
        default = filters.fir_plan(len(taps), mode, t_in, planes)
        for stages, tpb in itertools.product(TUNE_STAGES, TUNE_TILES):
            if stages > 1 and tpb == 1:
                continue            # a block of one tile fills one buffer
            plan = filters.fir_plan(len(taps), mode, t_in, planes,
                                    tiles_per_block=tpb, stages=stages)
            emit("banded_fir", x.shape,
                 lambda: filters._banded_fir_launch(x, taps, plan), ref,
                 plan, default, mode=mode, taps=len(taps))
    for planes, t, scs, bw in TUNE_FUSED_SHAPES:
        x = torch.randn((planes, t), generator=gen, device=dev)
        fir = filters.fir_coeff(scs, bw)
        ref = filters.fir_up2_fused_plain(x, fir, hb)
        default = filters.fused_plan(planes, t, len(fir), len(hb))
        for per in filters.FUSED_PERS:
            plan = filters.fused_plan(planes, t, len(fir), len(hb), per=per)
            emit("fir_up2_fused", x.shape,
                 lambda: filters.fir_up2_fused_planes(x, fir, hb, plan=plan),
                 ref, plan, default, reps=20, taps=len(fir))
    for scs, bw, nant, n_slots in SYMBOL_SHAPES:
        symp, cps, fir = _symbol_planes(ofdm, filters, gen, scs, bw, nant,
                                        n_slots)
        ref = filters.fir_up2_fused_symbols_plain(symp, cps, fir, hb)
        args = (2 * nant, n_slots, symp.shape[-1], len(fir), len(hb), cps)
        default = filters.fused_symbols_plan(*args)
        for group in filters.FUSED_GROUPS:
            plan = filters.fused_symbols_plan(*args, group=group)
            emit("fir_up2_fused_symbols", symp.shape,
                 lambda: filters.fir_up2_fused_symbols(symp, cps, fir, hb,
                                                       plan=plan),
                 ref, plan, default, taps=len(fir))


def _sample_clocks(stop: threading.Event, out: list) -> None:
    while not stop.is_set():
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        mhz, watts = r.stdout.strip().splitlines()[0].split(",")
        out.append((float(mhz), float(watts)))
        time.sleep(0.2)


def under_load(fn, seconds: float = 4.0) -> dict:
    """Run fn back to back for `seconds` while nvidia-smi samples the SM
    clock (MHz) and the power draw (W); the samples' range and median."""
    stop, samples = threading.Event(), []
    th = threading.Thread(target=_sample_clocks, args=(stop, samples))
    fn()
    torch.cuda.synchronize()
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    mhz = sorted(m for m, _ in samples)
    watts = sorted(w for _, w in samples)
    return dict(samples=len(samples), sm_mhz=[mhz[0], mhz[len(mhz) // 2],
                                              mhz[-1]],
                power_w=[watts[0], watts[len(watts) // 2], watts[-1]])


def _ffma_library() -> ctypes.CDLL:
    from python_5gtoolbox_tpu_torch import kernels
    src = pathlib.Path(__file__).with_name("ffma_peak.cu")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libffma_peak.so"
    subprocess.run([kernels._nvcc(), *kernels._ARCH, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out), str(src)],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.ffma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.ffma_peak.restype = ctypes.c_int
    return lib


def peak() -> None:
    from python_5gtoolbox_tpu_torch import kernels
    from python_5gtoolbox_tpu_torch.ops import filters
    from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import device_ms
    dev = torch.device("cuda")
    smi = _smi()
    lib = _ffma_library()
    blocks, iters = 16 * kernels.H100_SMS, 1 << 16
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def ffma():
        kernels.check("ffma_peak", lib.ffma_peak(out.data_ptr(), blocks,
                                                 iters, stream))

    ms = device_ms(ffma, 10)
    tflops = 2 * 8 * iters * 256 * blocks / ms * 1e-9
    print(json.dumps(dict(kernel="ffma_peak", blocks=blocks, iters=iters,
                          device_ms=ms, tflops=tflops, card=smi,
                          **under_load(ffma))), flush=True)
    fir, hb = filters.fir_coeff(30, 100), filters.halfband_coeff()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, 3932160), generator=gen, device=dev)

    def fused():
        filters.fir_up2_fused_planes(x, fir, hb)

    ms = device_ms(fused, 20)
    flops = 2 * (len(fir) + len(hb)) * x.numel()
    print(json.dumps(dict(kernel="fir_up2_fused", shape=list(x.shape),
                          taps=len(fir), device_ms=ms,
                          tflops=flops / ms * 1e-9,
                          share_of_ffma=flops / ms * 1e-9 / tflops,
                          card=smi, **under_load(fused))), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--tune"]:
        tune()
    elif sys.argv[1:] == ["--peak"]:
        peak()
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else "")
