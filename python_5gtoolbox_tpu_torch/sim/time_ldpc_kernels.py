"""Time the two min-sum LDPC kernels at the shapes their main paths give
them, on the card.

    python python_5gtoolbox_tpu_torch/sim/time_ldpc_kernels.py [LABEL]

Run as a file, it decodes with whichever python_5gtoolbox_tpu_torch comes
first on PYTHONPATH, so one call can time two trees of the repository in
turns (PYTHONPATH=old python .../time_ldpc_kernels.py old). Shapes: the
bench sweep's code (BG2 / Zc 352 / B 20 at -2 dB, flooded, ldpc_minsum),
the decoder bench (BG1 / Zc 384 / B 512, never-converging LLRs, flooded
L=32 and layered L=16, ldpc_minsum), the decoder study (BG1 / Zc 12 / B
400 at -0.5 dB, flooded and layered, ldpc_minsum_packed) and the
small-allocation sweep (BG2 / Zc 80 / B 20 at -2 dB, flooded,
ldpc_minsum_packed); all exact check node, alpha 0.8, beta 0.3, inputs
from a fixed seed (noisy codewords from sim/ldpc_decoder.py:
gen_ldpc_llr_batch, the decoder study's stimulus). Per shape one JSON line: device_ms (device time per
decode with the launches back to back), call_ms (CUDA events around
consecutive calls, host time included), a hash of the bits and ok flags
(equal between trees that give the same bits) and, where the tree has a
launch planner, its plan. Needs a CUDA device.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np
import torch

# kernel, zc, bgn, batch, snr_db (None: never-converging LLRs), schedule, L
SHAPES = [("ldpc_minsum", 352, 2, 20, -2.0, "flooded", 16),
          ("ldpc_minsum", 384, 1, 512, None, "flooded", 32),
          ("ldpc_minsum", 384, 1, 512, None, "layered", 16),
          ("ldpc_minsum_packed", 12, 1, 400, -0.5, "flooded", 16),
          ("ldpc_minsum_packed", 12, 1, 400, -0.5, "layered", 16),
          ("ldpc_minsum_packed", 80, 2, 20, -2.0, "flooded", 16)]
ALPHA, BETA = 0.8, 0.3


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn() with the calls back to back: a spin
    kernel holds the stream until the host has enqueued all reps calls
    (checked: its event must still be pending after the last one), so the
    host's time between launches does not count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * enqueue_s * 2e9) + 2_000_000
    for _ in range(6):
        held = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        held.record()
        for _ in range(reps):
            fn()
        end.record()
        pending = not held.query()
        torch.cuda.synchronize()
        if pending:
            return held.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host did not enqueue the calls "
                       "while the stream was held")


def call_ms(fn, reps: int = 20) -> float:
    """Mean time of fn() between CUDA events around reps calls, after one
    warm call: the device's time where the host keeps ahead of it, else
    the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def never_converging_llrs(rng, zc, bgn, batch, device):
    """LLRs of the decoder bench (bench.py:bench_ldpc), 4 * N(0, 1): no
    codeword converges, every one runs all its iterations and the final
    rule."""
    ncols = 68 if bgn == 1 else 52
    return torch.as_tensor(4.0 * rng.standard_normal(
        (batch, (ncols - 2) * zc), dtype=np.float32), device=device)


def main(label: str = "") -> None:
    from python_5gtoolbox_tpu_torch.ops.ldpc import decode
    from python_5gtoolbox_tpu_torch.sim.ldpc_decoder import gen_ldpc_llr_batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    plan = getattr(decode, "plan_launch", None)
    for name, zc, bgn, batch, snr, schedule, n_iter in SHAPES:
        llr = (never_converging_llrs(rng, zc, bgn, batch, dev) if snr is None
               else torch.as_tensor(gen_ldpc_llr_batch(
                   rng, zc, bgn, snr, batch, device=dev)[1], device=dev))
        kern = getattr(decode, name)

        def run():
            return kern(llr, zc, bgn, n_iter, ALPHA, BETA,
                        schedule=schedule)
        _, ok, full = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256(full.cpu().numpy().tobytes()
                                + ok.to(torch.int8).cpu().numpy().tobytes())
        reps = 3 if batch > 400 else 20
        row = dict(tree=label, kernel=name, bg=bgn, zc=zc, batch=batch,
                   snr_db=snr, schedule=schedule, n_iter=n_iter,
                   device_ms=device_ms(run, reps),
                   call_ms=call_ms(run, reps),
                   converged=int(ok.sum()),
                   bits_sha256=digest.hexdigest()[:16],
                   device=torch.cuda.get_device_name(0))
        if plan is not None:
            p = plan(bgn, zc, batch, schedule,
                     "packed" if name == "ldpc_minsum_packed" else "batch",
                     torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
            row.update(cluster=p.cluster, group=p.group, threads=p.threads,
                       warp_per_codeword=p.warp, lr_on_chip=p.lr_on_chip,
                       barriers_per_iteration=p.barriers)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
