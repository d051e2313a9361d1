"""Builds the CUDA kernels of `sparf_tpu_torch/csrc` with nvcc and loads them.

The library has a plain C interface and is loaded with ctypes; it does not
include PyTorch's headers. It is built at first use into
`sparf_tpu_torch/build/` (listed in .gitignore), under a name that carries a
hash of the sources, so an edited source is never served from a stale build.
Three compiles, run in parallel: fused_mlp.cu (K1, K2, K3 in 3xTF32 on
mma.sync, entry points sparf_fused_mlp_*_tf32), fused_mlp_wgmma.cu (K1,
K2, K3 at bf16 on wgmma and TMA, entry points sparf_fused_mlp_wg_*; K1, K2,
K3 in 3xTF32 on wgmma, sparf_fused_mlp_tf32wg_*) and fused_adam.cu (the
optimizer update, sparf_fused_adam; -fmad=false); one link makes the library.
Nothing here runs at import time.
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

from sparf_tpu_torch.utils import tracing

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
# (source, name of the compile in the log, its own flags)
COMPILES = (("fused_mlp.cu", "tf32", ()),
            ("fused_mlp_wgmma.cu", "wg", ()),
            ("fused_adam.cu", "adam", ("-fmad=false",)))
SOURCES = tuple(src for src, _, _ in COMPILES)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    h.update(repr(COMPILES).encode())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(defines: Sequence[str] = ()) -> Path:
    """Compile the kernels if this version of the sources has no library yet:
    one `nvcc -c` per source (COMPILES), both started together, then one link.
    `defines` (macro names) select a timing-only variant (csrc header note).
    The log holds each compile's output after a line `== <source> <kind> ==`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = (*NVCC_FLAGS, *(f"-D{m}" for m in defines))
    out = BUILD_DIR / f"libsparf_kernels_{_source_hash(flags)}.so"
    log = out.with_suffix(".log")
    if out.exists():
        BuildInfo.path = out
        BuildInfo.log = log.read_text() if log.exists() else ""
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc, t0 = _nvcc(), time.perf_counter()
    jobs = []
    for src, kind, own in COMPILES:
        obj = tmp.with_suffix(f".{Path(src).stem}.{kind}.o")
        cmd = [nvcc, *flags, *own, "-c", "-o", str(obj), str(CSRC_DIR / src)]
        jobs.append((f"{src} {kind}", cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, cmd, _, proc in jobs:
        text = proc.communicate()[0]
        logs.append(f"== {name} ==\n{' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(f"== link ==\n{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
    for _, _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "\n".join(logs)
    log.write_text(BuildInfo.log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{BuildInfo.log}")
    os.replace(tmp, out)
    BuildInfo.path = out
    return out


def entry(lib: ctypes.CDLL, name: str):
    """The C entry point sparf_fused_mlp_<name>_tf32 (the 3xTF32 kernels)."""
    return getattr(lib, f"sparf_fused_mlp_{name}_tf32")


def wg_entry(lib: ctypes.CDLL, name: str):
    """The C entry point sparf_fused_mlp_wg_<name> (the bf16 kernels)."""
    return getattr(lib, f"sparf_fused_mlp_wg_{name}")


def tf32wg_entry(lib: ctypes.CDLL, name: str):
    """The C entry point sparf_fused_mlp_tf32wg_<name> (the float32 kernels on wgmma)."""
    return getattr(lib, f"sparf_fused_mlp_tf32wg_{name}")


def load_library(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The kernel library, built on first call and then cached for the process
    (one per set of timing-only `defines`; the port uses the default)."""
    key = tuple(defines)
    if key not in _LIBS:
        with tracing.span("setup.kernels"):
            lib = ctypes.CDLL(str(build(key)))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (("sizes", [p, p]), ("pack", [p, p, p, p, p]),
                           ("forward", [p, p, p, i, p, p, p, i, p]),
                           ("backward", [p, p, p, p, p, p, p, p, p, p, i, p, p, p])):
            fn = entry(lib, name)
            fn.argtypes, fn.restype = args, i
        for name, args in (("sizes", [p, p]), ("layout", [p, p, p, p, p, p]),
                           ("forward", [p, p, p, i, p, p, p, p, p]),
                           ("forward_packed", [p, p, p, i, p, p, p, p]),
                           ("backward", [p, p, p, p, p, p, p, p, p, p, p, p, p, p, i, p, p, p])):
            fn = getattr(lib, f"sparf_fused_mlp_wg_{name}")
            fn.argtypes, fn.restype = args, i
        for name, args in (("sizes", [p, p]), ("layout", [p, p, p, p, p, p]),
                           ("forward", [p, p, p, i, p, p, p, p, p]),
                           ("forward_packed", [p, p, p, i, p, p, p, p]),
                           ("backward", [p, p, p, p, p, p, p, p, p, p, p, p, i, p, p, p])):
            fn = tf32wg_entry(lib, name)
            fn.argtypes, fn.restype = args, i
        lib.sparf_fused_adam.argtypes = [i, p, p, p, p, p, p, i, ctypes.c_float, p, p, p, p, i, p]
        lib.sparf_fused_adam.restype = i
        lib.sparf_cuda_error_string.argtypes = [i]
        lib.sparf_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return _LIBS[key]
