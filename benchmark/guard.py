"""What a benchmark run may not load, and what the reference may not import.

A run measures the PyTorch port alone: once its window has closed, no module
whose top-level name (the part before the first dot, compared whole) is one
of FORBIDDEN may be loaded in the process. `sparf_tpu_torch` begins with
`sparf_tpu`, so a prefix test would be wrong both ways.

The reference (benchmark/reference/) may import nothing of the program
either; `reference_imports` reads its sources, since the program is loaded
in the same process and a look at sys.modules cannot tell who imported it.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sparf_tpu"})
PROGRAM = "sparf_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = ()) -> List[str]:
    """Names in `modules` (default: sys.modules) whose top-level name is forbidden."""
    names = list(modules) or list(sys.modules)
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def reference_imports(directory: Path = REFERENCE_DIR) -> List[str]:
    """Imports of the reference's sources whose top-level name is the
    program's or a forbidden one: "<file>: <module>" each."""
    found = []
    for path in sorted(directory.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names
                      if top_level(n) in FORBIDDEN or top_level(n) == PROGRAM]
    return found
