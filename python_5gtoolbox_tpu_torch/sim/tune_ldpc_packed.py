"""Time ldpc_minsum_packed over its two launch parameters on the card.

    python -m python_5gtoolbox_tpu_torch.sim.tune_ldpc_packed

For the shapes of the decoder studies and of the small-allocation sweep
and for both schedules, decodes the same noisy codewords (the decoder
study's stimulus) with every (group, threads) pair the kernel takes,
checks each result against the default launch bit for bit, and prints
one JSON line per shape and schedule: the default launch's ms, the six
fastest pairs and all times.
The wrapper's defaults (ops/ldpc/decode.py:ldpc_minsum_packed) were
chosen from this output. Needs a CUDA device.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.ldpc import decode
from python_5gtoolbox_tpu_torch.sim.ldpc_decoder import gen_ldpc_llr_batch

# (zc, bgn, batch, snr_db)
SHAPES = [(12, 1, 400, -0.5), (16, 2, 400, 1.0), (80, 2, 20, -2.0),
          (112, 2, 400, -2.0)]
N_ITER, ALPHA, BETA = 16, 0.8, 0.3


def _ms(fn, reps: int = 10) -> float:
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


def main() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    print(torch.cuda.get_device_name(0), flush=True)
    for zc, bgn, batch, snr in SHAPES:
        _, llr = gen_ldpc_llr_batch(rng, zc, bgn, snr, batch, device=dev)
        llr = torch.as_tensor(llr, device=dev)
        g_max = decode.packed_group_limit(zc, bgn)
        for schedule in ("flooded", "layered"):
            def run(**kw):
                return decode.ldpc_minsum_packed(
                    llr, zc, bgn, N_ITER, ALPHA, BETA, schedule=schedule,
                    **kw)
            ref = run()
            times = {}
            for group in sorted({1, 2, 3, 4, 6, 8, 12, g_max}):
                for threads in (64, 128, 256, 512, 1024):
                    if group > min(g_max, threads):
                        continue
                    out = run(group=group, threads=threads)
                    if not torch.equal(out[2], ref[2]):
                        raise AssertionError(f"group {group}, threads "
                                             f"{threads}: other bits")
                    times[f"g{group}t{threads}"] = _ms(
                        lambda: run(group=group, threads=threads))
            best = sorted(times.items(), key=lambda kv: kv[1])[:6]
            print(json.dumps(dict(zc=zc, bgn=bgn, batch=batch,
                                  schedule=schedule, default_ms=_ms(run),
                                  best=best, all=times)), flush=True)


if __name__ == "__main__":
    main()
