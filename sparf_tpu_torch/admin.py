"""Machine-local environment settings (reference source/admin/:21-70 parity).

The reference generates `source/admin/local.py` holding workspace/dataset
paths per machine. Here: `sparf_tpu_torch/local_settings.py` (gitignored) with the
same role; `env_settings()` loads it or falls back to CLI/env-var paths.
"""
from __future__ import annotations

import importlib
import os
from typing import Optional

from sparf_tpu_torch.configs.config import ConfigDict

_TEMPLATE = '''"""Machine-local paths (auto-generated; edit freely)."""

workspace_dir = {workspace_dir!r}     # checkpoints / logs
tensorboard_dir = {tensorboard_dir!r}
eval_dir = {eval_dir!r}               # evaluation JSONs
log_dir = {log_dir!r}

# dataset roots
llff = {llff!r}
dtu = {dtu!r}
dtu_depth = {dtu_depth!r}
dtu_mask = {dtu_mask!r}
replica = {replica!r}
'''


def create_default_local_file(path: Optional[str] = None, **overrides) -> str:
    """Write the local settings template (reference environment.py:22-70)."""
    path = path or os.path.join(os.path.dirname(__file__), "local_settings.py")
    defaults = dict(
        workspace_dir="./workspace",
        tensorboard_dir="./workspace/tensorboard",
        eval_dir="./workspace/eval",
        log_dir="./workspace/log",
        llff="", dtu="", dtu_depth="", dtu_mask="", replica="",
    )
    defaults.update(overrides)
    with open(path, "w") as f:
        f.write(_TEMPLATE.format(**defaults))
    return path


def env_settings() -> ConfigDict:
    """Load machine-local settings; env vars SPARF_<KEY> override."""
    env = ConfigDict(
        workspace_dir="./workspace",
        tensorboard_dir=None,
        eval_dir=None,
        log_dir=None,
        llff="", dtu="", dtu_depth=None, dtu_mask=None, replica="",
    )
    try:
        local = importlib.import_module("sparf_tpu_torch.local_settings")
        for k in list(env.keys()):
            if hasattr(local, k):
                env[k] = getattr(local, k)
    except ImportError:
        pass
    for k in list(env.keys()):
        v = os.environ.get(f"SPARF_{k.upper()}")
        if v:
            env[k] = v
    return env
