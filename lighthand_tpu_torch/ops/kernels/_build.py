"""Build the CUDA kernels from ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a``. The libraries go to ``build/lighthand_tpu_torch/`` under the
repository root at first use, named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is not. All missing
libraries are built at once, one nvcc process per source. A failed build
raises with nvcc's output.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lighthand_tpu_torch"
SOURCES = ("fused_aug", "heatmap")

# No --use_fast_math: it changes division and expf. --fmad=false keeps
# a*b + c as two roundings, as the plain twins and the JAX kernels compute
# it. -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, str]:
    """Build every library that is missing, in parallel; return nvcc's
    output per source built (empty when everything was built already)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))
