"""Builds the CUDA kernels of `sparf_tpu_torch/csrc` with nvcc and loads them.

The library has a plain C interface and is loaded with ctypes; it does not
include PyTorch's headers, so a build takes seconds. It is built at first use
into `sparf_tpu_torch/build/` (listed in .gitignore), under a name that
carries a hash of the sources, so an edited source is never served from a
stale build. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("fused_mlp.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildInfo:
    """What the last build of this process did (read by chip_smoke.py)."""

    seconds: Optional[float] = None
    log: str = ""
    path: Optional[Path] = None


_LIBS: Dict[Tuple[str, ...], ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built only on a machine with "
                       "the CUDA toolkit (set NVCC or put nvcc on PATH)")


def _source_hash(flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(defines: Sequence[str] = ()) -> Path:
    """Compile the kernels if this version of the sources has no library yet.
    `defines` (macro names) select a timing-only variant (csrc header note)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = (*NVCC_FLAGS, *(f"-D{m}" for m in defines))
    out = BUILD_DIR / f"libsparf_kernels_{_source_hash(flags)}.so"
    log = out.with_suffix(".log")
    if out.exists():
        BuildInfo.path = out
        BuildInfo.log = log.read_text() if log.exists() else ""
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = proc.stdout + proc.stderr
    log.write_text(" ".join(cmd) + "\n" + BuildInfo.log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n{BuildInfo.log}")
    os.replace(tmp, out)
    BuildInfo.path = out
    return out


def load_library(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The kernel library, built on first call and then cached for the process
    (one per set of timing-only `defines`; the port uses the default)."""
    key = tuple(defines)
    if key not in _LIBS:
        lib = ctypes.CDLL(str(build(key)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sparf_fused_mlp_sizes.argtypes = [p, p]
        lib.sparf_fused_mlp_sizes.restype = i
        lib.sparf_fused_mlp_pack.argtypes = [p, p, p, p, p]
        lib.sparf_fused_mlp_pack.restype = i
        lib.sparf_fused_mlp_forward.argtypes = [p, p, p, i, p, p, p, i, p]
        lib.sparf_fused_mlp_forward.restype = i
        lib.sparf_fused_mlp_backward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, p, p, p]
        lib.sparf_fused_mlp_backward.restype = i
        lib.sparf_cuda_error_string.argtypes = [i]
        lib.sparf_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return _LIBS[key]
