"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of "workloads") names a configuration (its file is the
configuration's "file") and a traffic mix (portbench/traffic/<traffic>
.json); its comparison limits are portbench/limits/<cell>.json and each
per-layer metric is read by portbench/metrics/<metric>.py, all under the
checkout's root. A later change adds a cell, a configuration or a metric
by adding such files and entries.

A configuration's plain reference is portbench/reference/configs/
<configuration>.py where that file exists, else portbench/reference/
chain.py. Either module has

    point(cfg, traffic, snr_db, seed, trblks, device, bf16=False,
          llr_noise=0.0) -> dict

which returns chain.point's dict (tx, channel, grid, llr, ok, tbblk) and
may add the decoded side streams that compare.point_numbers counts:
streams={name: {equalizer: (bits (Sa, n) int8, ok (Sa,) bool)}} and
sent={name: (Sa, n) int8}. It imports nothing of the port and nothing of
JAX.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

DIR = "portbench"
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    reference: object


def load(root: pathlib.Path) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str):
    """The module in the file at path, loaded as name (registered, so
    that its dataclasses and pickles find it)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(root: pathlib.Path, config: str):
    """The plain reference of the configuration called config."""
    path = pathlib.Path(root) / DIR / "reference" / "configs" / f"{config}.py"
    if path.exists():
        return _module(path, f"portbench.reference.configs.{config}")
    return importlib.import_module("portbench.reference.chain")


def cell(root: pathlib.Path, bench: dict, name: str) -> Cell:
    """The cell called name, with its configuration, traffic and limits
    read from their files and its configuration's reference."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, workload=w,
        config=_json(pathlib.Path(root) / conf["file"]),
        traffic=_json(pathlib.Path(root) / DIR / "traffic"
                      / f"{w['traffic']}.json"),
        limits=_json(pathlib.Path(root) / DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        reference=reference(root, w["config"]))


def metric_reader(root: pathlib.Path, name: str):
    """The module portbench/metrics/<name>.py (SOURCE, UNIT, MOVES,
    read(run))."""
    return _module(pathlib.Path(root) / DIR / "metrics" / f"{name}.py",
                   f"portbench.metrics.{name}")
