"""Nothing the benchmark or its reference imports is JAX or the JAX
package, by whole top-level names; the reference imports nothing of the
port."""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from portbench.tests.tiny_cells import ROOT

BANNED = ("jax", "jaxlib", "flax", "python_5gtoolbox_tpu")
PORT = "python_5gtoolbox_tpu_torch"


def _loaded(modules: list[str]) -> list[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "JAX_PLATFORMS": "cpu"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_no_jax():
    mods = _loaded(["portbench.run", "portbench.harness",
                    "portbench.calibrate", f"{PORT}.sim.pdsch_throughput",
                    f"{PORT}.sim.pusch_throughput",
                    f"{PORT}.utils.profiling"])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(BANNED)
    assert PORT in tops           # the port is there, and is not banned


def test_the_reference_loads_nothing_of_the_port():
    """Every module under portbench/reference/ (a configuration's own
    reference under configs/ too), loaded by its file in one process: the
    top-level names it adds to sys.modules."""
    paths = sorted(str(p) for p in (ROOT / "portbench/reference")
                   .rglob("*.py"))
    code = ("import importlib.util, json, sys\n"
            "added = {}\n"
            f"for i, path in enumerate({paths!r}):\n"
            "    before = set(sys.modules)\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        f'_reference_{i}', path)\n"
            "    mod = sys.modules[spec.name] = \\\n"
            "        importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    added[path] = sorted({m.split('.')[0]\n"
            "                          for m in set(sys.modules) - before})\n"
            "print(json.dumps(added))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "JAX_PLATFORMS": "cpu"})
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(added) == paths
    assert "portbench/reference/chain.py" in {
        str(pathlib.Path(p).relative_to(ROOT)) for p in added}
    for path, tops in added.items():
        assert not set(tops) & (set(BANNED) | {PORT}), (path, tops)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "portbench").rglob("*.py")
    if "tests" not in p.parts))
def test_no_source_imports_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & set(BANNED), path
    if pathlib.PurePath(path).parts[1] == "reference":
        assert PORT not in tops, path
