"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and
the port (python_5gtoolbox_tpu_torch). The last line of standard output
is one JSON object: correct, attempted, failed, metrics (--trace 0: the
cell's end-to-end metrics; --trace 1: its per-layer metrics), device
(and with --trace 1 breakdown) and, last, checks: each number compared
with the reference beside its limit. The same numbers are the
last lines of standard error. Exits non-zero, printing no result, where
torch sees no CUDA device or fewer than the cell asks for, where a JAX
module is loaded once the window has closed, or where the port is not
there.

Caches stay inside the checkout, at fixed paths under build/: the port's
nvcc-built kernels (build/kernels/, the port's own choice), PyTorch's
runtime-compiled kernels, Triton's and the CUDA driver's caches.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path.cwd()
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host side of a point is serial
# Python, and idle worker pools only add wake-ups to the load
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def _fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _finite(x):
    """x, or None where it is not a finite number (a missing output)."""
    return x if x == x and abs(x) != float("inf") else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    torch.set_num_threads(1)

    bench = spec.load(ROOT)
    cell = spec.cell(ROOT, bench, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        _fail("torch sees no CUDA device", 2)
    if torch.cuda.device_count() < chips:
        _fail(f"the cell needs {chips} cards, torch sees "
              f"{torch.cuda.device_count()}", 2)
    seed = args.seed % 2 ** 62
    res = harness.measure(cell, seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    if res["banned"]:
        _fail(f"JAX modules loaded: {', '.join(res['banned'])}", 3)

    if args.trace:
        run = res["run"]
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(ROOT, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"sim_slots_per_s": res["rate"], "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=chips, memory_peak_bytes=res["peak"])
    if args.trace:
        device.update(busy_s=res["run"].busy_s,
                      window_s=res["run"].trace_window_s)
    out = dict(correct=res["correct"], attempted=res["attempted"],
               failed=res["failed"], metrics=metrics, device=device)
    if args.trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {name: {"value": _finite(value), "limit": limit}
                     for name, value, limit in res["rows"]}
    print(f"portbench: {cell.name} seed {args.seed} window "
          f"{res['window_s']:.3f} s, {res['attempted']} points, "
          f"card {harness.card()}", file=sys.stderr)
    for name, value, limit in res["rows"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
