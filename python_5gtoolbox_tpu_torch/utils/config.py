"""Default configuration system.

Behavior parity target: py5gphy/nr_default_config/*.json loaded via
json.load and mutated by callers (SURVEY.md L0). Same schema and key
names so reference configs translate 1:1; `enable` flags keep the
reference's "True"/"False" string quirk.
"""
from __future__ import annotations

import copy
import json
import pathlib

_CONFIG_DIR = pathlib.Path(__file__).resolve().parents[1] / "configs"


def get_default_config(name: str) -> dict:
    """Load a default config by short name, e.g. 'ssb', 'dl_carrier'."""
    for fname in (f"default_{name}_config.json", f"default_{name}.json"):
        path = _CONFIG_DIR / fname
        if path.exists():
            with open(path) as f:
                return json.load(f)
    raise FileNotFoundError(f"no default config for {name!r} in {_CONFIG_DIR}")


def merged(base: dict, override: dict | None) -> dict:
    """Deep-merge override into a copy of base."""
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out
