"""Time the two min-sum LDPC kernels over their launch parameters on the
card.

    python -m python_5gtoolbox_tpu_torch.sim.tune_ldpc_packed

For the shapes of the decoder studies and of the small-allocation sweep
(ldpc_minsum_packed) and of the bench sweep and the decoder bench
(ldpc_minsum), and for both schedules, decodes the same codewords (the
decoder study's stimulus; never-converging LLRs at the decoder bench's
shape) with every cluster size K the lifting allows, groups G across their
range, several thread counts and (ldpc_minsum) LR in device memory
(suffix "dev"), checks each result against the planned
launch bit for bit, and prints one JSON line per kernel, shape and
schedule: the planned launch and its device time per decode (launches
back to back, time_ldpc_kernels.device_ms), the six fastest (K, G,
threads) and all times. The planner's defaults (ops/ldpc/decode.py:plan_launch)
were chosen from this output. Needs a CUDA device.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from python_5gtoolbox_tpu_torch.ops.ldpc import decode
from python_5gtoolbox_tpu_torch.sim.ldpc_decoder import gen_ldpc_llr_batch
from python_5gtoolbox_tpu_torch.sim.time_ldpc_kernels import (
    device_ms, never_converging_llrs)

# (kernel, zc, bgn, batch, snr_db or None for never-converging LLRs, L)
SHAPES = [("ldpc_minsum_packed", 12, 1, 400, -0.5, 16),
          ("ldpc_minsum_packed", 16, 2, 400, 1.0, 16),
          ("ldpc_minsum_packed", 80, 2, 20, -2.0, 16),
          ("ldpc_minsum_packed", 112, 2, 400, -2.0, 16),
          ("ldpc_minsum", 352, 2, 20, -2.0, 16),
          ("ldpc_minsum", 384, 1, 512, None, 16)]
ALPHA, BETA = 0.8, 0.3
THREADS = (128, 256, 512, 1024)


def _plans(zc, bgn, batch, schedule, layout):
    """label -> every launch plan the planner accepts for this decode:
    each cluster size, groups 1, 2, 3, 4, 6, 8, 12 and the limit, each of
    THREADS, and (layout "batch") LR in device memory (suffix "dev")."""
    g_max = decode.packed_group_limit(zc, bgn) if layout == "packed" else 1
    forced = [dict(cluster=k, group=g, threads=t)
              for g in sorted({1, 2, 3, 4, 6, 8, 12, g_max}) if g <= g_max
              for k in decode.cluster_slices(zc) for t in THREADS]
    if layout == "batch":
        forced += [dict(cluster=1, threads=t, lr_on_chip=False)
                   for t in THREADS]
    out = {}
    for kw in forced:
        try:
            p = decode.plan_launch(bgn, zc, batch, schedule, layout, **kw)
        except ValueError:
            continue
        out[f"k{p.cluster}g{p.group}t{p.threads}"
            + ("" if p.lr_on_chip else "dev")] = p
    return out


def main() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(torch.cuda.get_device_name(0), flush=True)
    for name, zc, bgn, batch, snr, n_iter in SHAPES:
        if snr is None:
            llr = never_converging_llrs(rng, zc, bgn, batch, dev)
        else:
            _, llr = gen_ldpc_llr_batch(rng, zc, bgn, snr, batch, device=dev)
            llr = torch.as_tensor(llr, device=dev)
        kern = getattr(decode, name)
        layout = "packed" if name == "ldpc_minsum_packed" else "batch"
        for schedule in ("flooded", "layered"):
            def run(plan=None):
                return kern(llr, zc, bgn, n_iter, ALPHA, BETA,
                            schedule=schedule, plan=plan)
            ref = run()
            times = {}
            for label, forced in _plans(zc, bgn, batch, schedule,
                                        layout).items():
                out = run(forced)
                if not (torch.equal(out[2], ref[2])
                        and torch.equal(out[1], ref[1])):
                    raise AssertionError(f"{name} {label}: other bits")
                times[label] = device_ms(lambda: run(forced),
                                         3 if batch > 400 else 10)
            best = sorted(times.items(), key=lambda kv: kv[1])[:6]
            plan = decode.plan_launch(bgn, zc, batch, schedule, layout, n_sm)
            print(json.dumps(dict(
                kernel=name, zc=zc, bgn=bgn, batch=batch, snr_db=snr,
                schedule=schedule, plan=dict(cluster=plan.cluster,
                                             group=plan.group,
                                             threads=plan.threads,
                                             warp=plan.warp,
                                             lr_on_chip=plan.lr_on_chip),
                plan_ms=device_ms(run, 3 if batch > 400 else 10), best=best,
                all=times)), flush=True)


if __name__ == "__main__":
    main()
