"""BENCHMARK.json against the benchmark's contract, and the harness
finding cells, configurations and metrics by name."""
from __future__ import annotations

import json
import shutil

import pytest

from portbench import bounds, spec
from portbench.reference import chain
from portbench.tests.tiny_cells import CELLS, ROOT

BENCH = spec.load(ROOT)
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra
        assert spec.NAME_RE.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _one_line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert spec.NAME_RE.match(e[key])


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        layer = [m for m in BENCH["per_layer"] if spec.applies(m, w["name"])]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.cell(ROOT, BENCH, name)
    assert cell.traffic["equalizers"]
    assert cell.config["name"] == cell.workload["config"]
    assert set(cell.limits) >= {"tx_err", "channel_err", "grid_err",
                                "flag_mismatch", "passed_tb_wrong"}
    for algo in cell.traffic["equalizers"]:
        assert f"llr_err.{algo}" in cell.limits
    assert cell.reference.point is chain.point


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_declares_itself(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    mod = spec.metric_reader(ROOT, metric)
    assert (mod.SOURCE, mod.UNIT, mod.MOVES) == (
        entry["source"], entry["unit"], entry["moves"])
    assert callable(mod.read)


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]


def test_added_files_add_a_cell_and_a_metric(tmp_path):
    """A new cell and a new per-layer metric come from new files and
    entries alone: nothing that is there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    new = "pdsch_100mhz.tdla30_fm100_batched"
    traffic = json.loads((ROOT / "portbench/traffic"
                          / f"{CELLS[0]}.json").read_text())
    traffic["channel"]["fm_inHz"] = 100
    (tmp_path / "portbench/traffic" / f"{new}.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/limits" / f"{new}.json").write_text(
        (ROOT / "portbench/limits" / f"{CELLS[0]}.json").read_text())
    (tmp_path / "portbench/metrics/points_traced.py").write_text(
        'SOURCE = "device_trace"\nUNIT = "count"\n'
        'MOVES = "sim_slots_per_s"\n\n\n'
        'def read(run):\n    return run.trace_points or None\n')
    bench["workloads"].append(dict(BENCH["workloads"][0], name=new,
                                   traffic=new))
    bench["per_layer"].append(dict(
        name="points_traced", unit="count", better="higher",
        source="device_trace", layer="device", moves="sim_slots_per_s",
        workloads=[new]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(tmp_path, spec.load(tmp_path), new)
    assert cell.traffic["channel"]["fm_inHz"] == 100
    assert [m["name"] for m in cell.per_layer][-1] == "points_traced"

    class Run:
        trace_points = 3
    assert spec.metric_reader(tmp_path, "points_traced").read(Run()) == 3
    old = spec.cell(tmp_path, spec.load(tmp_path), CELLS[0])
    assert "points_traced" not in [m["name"] for m in old.per_layer]


def test_banded_fir_count_matches_the_kernel_table():
    """PERF.md's kernel table: 2x2457600 'same' with 287 taps is bounded
    by its operations at 0.042109 ms."""
    n_ops, n_bytes = bounds.banded_fir_work(2, 2457600, 287, "same")
    secs, by = bounds.least_seconds(n_ops, n_bytes)
    assert by == "operations"
    assert secs * 1e3 == pytest.approx(0.042109, abs=5e-7)
    assert n_bytes == 4 * (2 * 2457600 * 2 + 287)
    up_ops, _ = bounds.banded_fir_work(4, 614400, 55, "up2")
    assert up_ops == 55 * 4 * 1228800
