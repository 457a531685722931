"""YAML config tree with recursive ``base_config`` include-merge.

Counterpart of ``genpercept_tpu/utils/config.py``: a config file may list
``base_config: [paths...]``; the bases merge in order, then the file itself
wins. ``yaml`` is imported by the loader only, so the rest of the package
needs no PyYAML.
"""

from __future__ import annotations

import os
from typing import Any, Dict


class Config(dict):
    """dict with attribute access, recursive over nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def recursive_load_config(path: str) -> Config:
    """Depth-first include-merge of ``base_config`` (paths relative to the
    working directory, as the JAX package reads them)."""
    conf = load_yaml(path)
    merged: Dict = {}
    for base in conf.get("base_config", []):
        if not os.path.exists(base):
            raise FileNotFoundError(f"base config not found: {base}")
        merged = _merge(merged, dict(recursive_load_config(base)))
    merged = _merge(merged, conf)
    merged.pop("base_config", None)
    return Config(merged)
