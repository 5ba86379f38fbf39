"""Recorded outputs of the JAX package for the port's costliest comparisons.

Some port tests hold the port against JAX functions whose compile takes a
minute or more on the CPU (the Pallas LDPC kernels in interpret mode, the
XLA LDPC decoder at large liftings, the UCI path end to end). The JAX
package is frozen, so those tests read its outputs from a recording made
by tests/torch_oracles/make.py instead of compiling it on every run.

A recording (<case>.npz) holds the JAX outputs and three checks, each of
which fails the test when it no longer holds:

- the sha256 of every JAX source file the case depends on (the import
  closure of the named modules inside python_5gtoolbox_tpu, and the
  package's data and config files);
- jax.__version__;
- the sha256 of the inputs, which the test regenerates from its seed.

The test's inputs, shapes and tolerances are those of the live
comparison. With TORCH_ORACLES_RECORD=1 (make.py sets it) the test runs
the JAX side live, writes the recording and compares as usual.
"""
from __future__ import annotations

import ast
import functools
import hashlib
import json
import os
import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[1]
PKG = "python_5gtoolbox_tpu"
RECORD_ENV = "TORCH_ORACLES_RECORD"


def _module_file(name: str) -> pathlib.Path | None:
    p = REPO / pathlib.Path(*name.split("."))
    if (p / "__init__.py").exists():
        return p / "__init__.py"
    if p.with_suffix(".py").exists():
        return p.with_suffix(".py")
    return None


def _imports(path: pathlib.Path, name: str) -> set:
    """Modules of the package that `path` imports, at any depth of its
    code (function-level imports too)."""
    pkg = name if path.name == "__init__.py" else name.rpartition(".")[0]
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            found.add(mod)
            found.update(f"{mod}.{a.name}" for a in node.names)
    return {m for m in found if m == PKG or m.startswith(PKG + ".")}


@functools.lru_cache(maxsize=None)
def jax_sources(modules: tuple) -> tuple:
    """The package's .py files in the import closure of `modules`, with
    every parent package's __init__.py, and its data and config files."""
    seen = {}
    todo = list(modules)
    while todo:
        parts = todo.pop().split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name in seen:
                continue
            f = _module_file(name)
            if f is None:          # a name imported from a module
                continue
            seen[name] = f
            todo.extend(_imports(f, name))
    files = set(seen.values())
    files.update(p for p in (REPO / PKG).rglob("*")
                 if p.is_file() and p.suffix in (".json", ".npz", ".npy"))
    return tuple(sorted(str(f.relative_to(REPO)) for f in files))


def _sha(path: str) -> str:
    return hashlib.sha256((REPO / path).read_bytes()).hexdigest()


def inputs_digest(*items) -> str:
    """sha256 over arrays (dtype, shape, bytes) and JSON-able values."""
    h = hashlib.sha256()
    for x in items:
        if hasattr(x, "detach"):            # a torch tensor
            x = x.detach().cpu().numpy()
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
            h.update(f"{x.dtype.str}{x.shape}".encode())
            h.update(x.tobytes())
        else:
            h.update(json.dumps(x, sort_keys=True, default=repr).encode())
    return h.hexdigest()


def recording_path(case: str) -> pathlib.Path:
    return HERE / f"{case}.npz"


def jax_outputs(case: str, modules, inputs: tuple, compute) -> dict:
    """The JAX outputs of `case`: compute() run live under
    TORCH_ORACLES_RECORD=1 (and recorded), else read from the recording,
    which must match the JAX sources, jax.__version__ and the inputs."""
    import jax

    modules = tuple(modules)
    meta = dict(jax=jax.__version__, inputs=inputs_digest(*inputs),
                sources={f: _sha(f) for f in jax_sources(modules)},
                modules=list(modules))
    path = recording_path(case)
    if os.environ.get(RECORD_ENV) == "1":
        out = {k: np.asarray(v) for k, v in compute().items()}
        np.savez_compressed(path, __meta__=np.array(json.dumps(meta)), **out)
        return out
    stale = "; regenerate with: python tests/torch_oracles/make.py"
    assert path.exists(), f"no recording {path.name}{stale}"
    with np.load(path) as z:
        rec = json.loads(str(z["__meta__"]))
        out = {k: z[k] for k in z.files if k != "__meta__"}
    assert rec["jax"] == meta["jax"], \
        f"{case}: recorded with jax {rec['jax']}, running {meta['jax']}{stale}"
    changed = sorted(f for f in set(rec["sources"]) | set(meta["sources"])
                     if rec["sources"].get(f) != meta["sources"].get(f))
    assert not changed, f"{case}: JAX sources changed: {changed}{stale}"
    assert rec["inputs"] == meta["inputs"], \
        f"{case}: the test's inputs differ from the recorded ones{stale}"
    return out


def jax_tuple(case: str, modules, inputs: tuple, compute) -> tuple:
    """jax_outputs for a JAX function that returns a tuple of arrays."""
    out = jax_outputs(case, modules, inputs,
                      lambda: {f"out{i}": o for i, o in enumerate(compute())})
    return tuple(out[f"out{i}"] for i in range(len(out)))
