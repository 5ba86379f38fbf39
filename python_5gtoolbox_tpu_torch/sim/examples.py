"""The command line shared by the PDSCH and PUSCH example modules
(nr_pdsch_throughput_example, nr_pdsch_ber_example,
nr_pusch_throughput_example, nr_pusch_ber_example): --device, --seed,
--out-dir (default out/torch, beside the JAX scripts' out/, whose files
the same names would overwrite), the sweep, the pickle the JAX script
writes and its printout."""
from __future__ import annotations

import argparse
import json
import pathlib
import pickle

from python_5gtoolbox_tpu_torch.utils.platform import select_platform
from python_5gtoolbox_tpu_torch.utils.profiling import StageProfiler


def run_example(doc: str, config: dict, run, argv=None, ber=False,
                profile_json=None, prof=None) -> dict:
    """Run one example: config (the example's constants, see its
    example_config) through run (run_pdsch_throughput or
    run_pusch_throughput) -> the results dict; pickles [dict(Nt, Nr,
    snr_db_list), results] (ber: the TB BLER 1 - pass rate per
    equalizer) to <out-dir>/<config['filename']>; profile_json: also
    write there each stage's and span's calls, seconds, items, unit and
    parent (the enclosing stage, null at the top), and under "counters"
    the counters where there are any (ldpc_iterations: the LDPC kernels'
    updates, summed over the codewords of the rx.ldpc span's items).
    prof: the stage timer (default a utils.profiling.StageProfiler on the
    device). The device
    is --device, else utils.platform.select_platform's (the card, or the
    host under PY5G_FORCE_CPU=1)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU under "
                         "PY5G_FORCE_CPU=1)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the transport blocks and the channel")
    ap.add_argument("--out-dir", default="out/torch")
    args = ap.parse_args(argv)
    device = select_platform("sweep", args.device)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof = prof or StageProfiler(device)
    results = run(config["carrier"], config["channel"], config["chan_cfg"],
                  config["snr_db_list"], config["ceq_algo_list"],
                  n_slots=config["n_slots"], ce_config=config.get("ce"),
                  seed=args.seed, device=device, prof=prof)
    algos = config["ceq_algo_list"]
    out = {a: [1.0 - p for p in results[a]] for a in algos} if ber \
        else results
    head = dict(Nt=config["Nt"], Nr=config["Nr"],
                snr_db_list=config["snr_db_list"])
    with open(out_dir / config["filename"], "wb") as f:
        pickle.dump([head, out], f)
    if profile_json:
        stages = {k: dict(calls=s.calls, seconds=s.seconds, items=s.items,
                          unit=s.unit, parent=s.parent)
                  for k, s in prof.stats.items()}
        if prof.counters:
            stages["counters"] = dict(prof.counters)
        with open(out_dir / profile_json, "w") as f:
            json.dump(stages, f, indent=1)
    for a in algos:
        print(f"{a}: {'BLER' if ber else 'pass rates'} {out[a]}")
    return out
