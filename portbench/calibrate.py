"""Readings that the comparison limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--perturbed-seeds 4,5 --noise 1e-4]
        [--out FILE]

For each seed of --seeds, the program runs the points a run with that
seed compares (the same draw from the seed as harness.measure) and the
numbers are read against the cell's reference (spec.reference), as a
run reads them: the lower readings. For each seed of --control-seeds the
control takes the program's place: the reference with its signals kept
in bfloat16 (bf16=True), against the reference: the upper readings.
--perturbed-seeds: the reference with its LLRs perturbed by --noise
(relative), against the reference: how near the CRC flags lie to a flip
at that size. One JSON line per seed and side; with --out
also appended to that file. Needs a CUDA device, as a run does; on the
CPU (--device cpu) it reads a small cell for the tests.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import pathlib
import random
import sys
import time

import torch

from portbench import compare, harness, probe as probe_mod, spec


def sampled_points(cell, seed: int) -> list[int]:
    check = cell.traffic["check"]
    return sorted(random.Random(seed).sample(
        range(1, check["among_first"] + 1), check["points"]))


def program_readings(cell, seed: int, device) -> dict:
    """The numbers a run with this seed compares, from the program."""
    program = harness.Program(cell, device)
    probe = probe_mod.Probe()
    probe.install()
    per_point = []
    try:
        for i in sampled_points(cell, seed):
            si = program.seed(seed, i)
            trb = program.trblks(si)
            probe.arm(i)
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                program.point(si, program.snr(i), trb)
            probe.disarm()
            got = probe.outputs(i)
            ref = cell.reference.point(copy.deepcopy(cell.config),
                                       cell.traffic, program.snr(i), si, trb,
                                       device)
            per_point.append(compare.point_numbers(got, ref, trb))
            probe.taken.pop(i)
    finally:
        probe.uninstall()
    return compare.combine(per_point)


def control_readings(cell, seed: int, device) -> dict:
    """The same numbers with the bfloat16 control in the program's
    place."""
    program = harness.Program(cell, device)
    per_point = []
    for i in sampled_points(cell, seed):
        si = program.seed(seed, i)
        trb = program.trblks(si)
        args = (cell.traffic, program.snr(i), si, trb, device)
        got = cell.reference.point(copy.deepcopy(cell.config), *args,
                                   bf16=True)
        ref = cell.reference.point(copy.deepcopy(cell.config), *args)
        per_point.append(compare.point_numbers(got, ref, trb))
    return compare.combine(per_point)


def perturbed_readings(cell, seed: int, device, noise: float) -> dict:
    """The numbers of the reference with its LLRs perturbed by
    noise (relative, Gaussian) against the reference: how many CRC
    flags a perturbation of that size moves."""
    program = harness.Program(cell, device)
    per_point = []
    for i in sampled_points(cell, seed):
        si = program.seed(seed, i)
        trb = program.trblks(si)
        args = (cell.traffic, program.snr(i), si, trb, device)
        got = cell.reference.point(copy.deepcopy(cell.config), *args,
                                   llr_noise=noise)
        ref = cell.reference.point(copy.deepcopy(cell.config), *args)
        per_point.append(compare.point_numbers(got, ref, trb))
    return compare.combine(per_point)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--perturbed-seeds", default="",
                    help="seeds for the reference with perturbed LLRs")
    ap.add_argument("--noise", type=float, default=1e-4,
                    help="relative LLR perturbation of those runs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    cell = spec.cell(root, spec.load(root), args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("calibrate: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = harness.card() if dev.type == "cuda" else "cpu"
    jobs = [(side, int(s)) for side, seeds in (
        ("program", args.seeds), ("control", args.control_seeds),
        ("perturbed", args.perturbed_seeds)) for s in seeds.split(",") if s]
    for side, seed in jobs:
        t0 = time.perf_counter()
        if side == "perturbed":
            nums = perturbed_readings(cell, seed % 2 ** 62, dev, args.noise)
        else:
            fn = program_readings if side == "program" else control_readings
            nums = fn(cell, seed % 2 ** 62, dev)
        row = dict(workload=cell.name, side=side, seed=seed,
                   numbers={k: (v if v == v and abs(v) != float("inf")
                                else None) for k, v in nums.items()},
                   seconds=time.perf_counter() - t0, card=card)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
