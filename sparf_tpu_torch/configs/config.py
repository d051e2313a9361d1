"""Hierarchical attribute-dict configs with yaml round-trip.

Functional parity with the reference's easydict-based config system
(source/utils/config_utils.py:26-125): recursive override, `_parent_`
chaining on load, dotted-key CLI parsing, save/load next to checkpoints.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import yaml


class ConfigDict(dict):
    """dict with attribute access; nested dicts are converted recursively."""

    def __init__(self, d: Optional[dict] = None, **kwargs):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v for v in value)
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def copy(self) -> "ConfigDict":
        return ConfigDict(to_plain(self))

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def to_plain(cfg: Any) -> Any:
    """ConfigDict tree -> plain python for yaml serialization."""
    if isinstance(cfg, dict):
        return {k: to_plain(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_plain(v) for v in cfg]
    return cfg


def override_options(
    opt: ConfigDict,
    opt_over: Optional[dict],
    key_stack: Optional[List[str]] = None,
    safe_check: bool = False,
) -> ConfigDict:
    """Recursively merge opt_over into opt (reference config_utils.py:51-68)."""
    if opt_over is None:
        return opt
    key_stack = key_stack or []
    for key, value in opt_over.items():
        if isinstance(value, dict) and key in opt and isinstance(opt.get(key), dict):
            opt[key] = override_options(opt[key], value, key_stack + [key], safe_check)
        else:
            if safe_check and key not in opt:
                dotted = ".".join(key_stack + [key])
                raise KeyError(f"unknown config option {dotted!r}")
            opt[key] = value
    return opt


def load_options(fname: str) -> ConfigDict:
    """Load yaml options, chaining through `_parent_` (config_utils.py:70-84)."""
    with open(fname) as f:
        opt = ConfigDict(yaml.safe_load(f) or {})
    parent_name = opt.get("_parent_")
    if parent_name:
        parent = load_options(parent_name)
        opt = override_options(parent, opt)
    return opt


def save_options_file(opt: ConfigDict, output_path: str, name: str = "options.yaml") -> str:
    """Serialize full config next to checkpoints (config_utils.py:86-108)."""
    os.makedirs(output_path, exist_ok=True)
    fname = os.path.join(output_path, name)
    with open(fname, "w") as f:
        yaml.safe_dump(to_plain(opt), f, default_flow_style=False, sort_keys=False)
    return fname


def _auto_cast(value: str) -> Any:
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def parse_dotted_args(args: List[str], base: Optional[ConfigDict] = None) -> ConfigDict:
    """Parse `--a.b.c=value` CLI overrides (reference config_utils.py:26-49)."""
    opt = base if base is not None else ConfigDict()
    for arg in args:
        if not arg.startswith("--"):
            raise ValueError(f"expected --key=value, got {arg!r}")
        body = arg[2:]
        if "=" in body:
            key, value = body.split("=", 1)
            parsed: Any = _auto_cast(value)
        else:
            key, parsed = body, True
        node = opt
        parts = key.split(".")
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = parsed
    return opt
