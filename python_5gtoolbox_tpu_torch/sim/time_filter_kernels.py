"""Time the filter kernels at the shapes their main paths give them, on
the card.

    python python_5gtoolbox_tpu_torch/sim/time_filter_kernels.py [LABEL]
    python python_5gtoolbox_tpu_torch/sim/time_filter_kernels.py --tune

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
* fir_up2_fused (4x307200 with 71 + 55 taps, 4x3932160 with 287 + 55) and
  fir_up2_fused_symbols (scs 15 / BW 5, 2 antennas, 20 slots), which share
  the DUC tile routine.

--tune times banded_fir at the same shapes with each forced pair of ring
depth (stages) and tiles per block (TUNE_STAGES x TUNE_TILES); the plan's
rule (ops/filters.py:fir_plan, FIR_RING_OUTPUTS_PER_SM) comes from it.

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

import dataclasses
import itertools
import json
import subprocess
import sys
import time

import torch

CLUSTERS = (1, 4, 8, 16)
TUNE_STAGES = (1, 2)
TUNE_TILES = (1, 2, 4)


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
            "cluster")
    out = {k: v for k, v in dataclasses.asdict(plan).items() if k in keep}
    for k in ("blocks", "idfts_per_symbol", "smem_bytes"):
        if hasattr(plan, k):
            out[k] = getattr(plan, k)
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

    for planes, t, bw in ((4, 307200, 20), (4, 3932160, 100)):
        x = torch.randn((planes, t), generator=gen, device=dev)
        fir = filters.fir_coeff(30, bw)
        emit("fir_up2_fused", x.shape,
             lambda: filters.fir_up2_fused_planes(x, fir, hb),
             lambda: filters.fir_up2_fused_plain(x, fir, hb), reps=20,
             taps=len(fir))
    n_sc = 12 * ofdm.num.carrier_prb_size(15, 5)
    fd = torch.complex(
        torch.randn((2, 20, 14, n_sc), generator=gen, device=dev),
        torch.randn((2, 20, 14, n_sc), generator=gen, device=dev))
    symp = ofdm.tx_low_phy_sym_planes(fd, 15, 5, fc)
    cps = ofdm._cp_table(15, symp.shape[-1])
    fir = filters.fir_coeff(15, 5)
    emit("fir_up2_fused_symbols", symp.shape,
         lambda: filters.fir_up2_fused_symbols(symp, cps, fir, hb),
         lambda: filters.fir_up2_fused_symbols_plain(symp, cps, fir, hb),
         taps=len(fir))


def tune() -> None:
    from python_5gtoolbox_tpu_torch.ops import filters
    from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import device_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    smi = _smi()
    for planes, t_in, taps, mode in _fir_shapes(filters):
        x = torch.randn((planes, t_in), generator=gen, device=dev)
        ref = filters.banded_fir_plain(x, taps, mode)
        for stages, tpb in itertools.product(TUNE_STAGES, TUNE_TILES):
            if stages > 1 and tpb == 1:
                continue            # a block of one tile fills one buffer
            plan = filters.fir_plan(len(taps), mode, t_in, planes,
                                    tiles_per_block=tpb, stages=stages)

            def run():
                return filters._banded_fir_launch(x, taps, plan)
            err = (run() - ref).abs().max().item()
            print(json.dumps(dict(
                kernel="banded_fir", shape=[planes, t_in], mode=mode,
                taps=len(taps), stages=stages, tiles_per_block=tpb,
                blocks=plan.blocks,
                smem_bytes=plan.smem_bytes, device_ms=device_ms(run, 50),
                max_abs_err=err,
                default=plan == filters.fir_plan(len(taps), mode, t_in,
                                                 planes),
                card=smi)), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--tune"]:
        tune()
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else "")
