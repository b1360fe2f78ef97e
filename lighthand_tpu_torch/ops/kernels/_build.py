"""Build the native sources in ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled with
nvcc for ``sm_90a``. Each ``csrc/<name>.cpp`` is host code (the image codec
and the TSV engine of the data readers), compiled with the host C++
compiler, so it builds without a card too. The libraries go to
``build/lighthand_tpu_torch/`` under the repository root at first use,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is not. All missing libraries asked for are built at
once, one compiler process per source. A failed build raises with the
compiler's output.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lighthand_tpu_torch"
SOURCES = ("batch_norm", "fused_aug", "heatmap", "int8_conv",
           "rasterize")  # csrc/<name>.cu
HOST_SOURCES = ("imageio", "tsv_engine", "text")  # host C++, csrc/<name>.cpp

# No --use_fast_math: it changes division and expf. --fmad=false keeps
# a*b + c as two roundings, as the plain twins and the JAX kernels compute
# it. -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# -ffp-contract=off: the codec's float arithmetic (csrc/imageio.cpp) spells
# out where it fuses a multiply and an add.
CXX_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC")


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


def cxx_path() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler found: put g++ on PATH")
    return found


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def library_path(name: str) -> Path:
    host = name in HOST_SOURCES
    h = hashlib.sha256(" ".join(CXX_FLAGS if host else NVCC_FLAGS).encode())
    headers = [] if host else sorted(CSRC.glob("*.cuh"))
    for src in [_source(name), *headers]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def cxx_command(name: str, out: Path) -> List[str]:
    return [cxx_path(), *CXX_FLAGS, "-o", str(out), str(_source(name))]


def build_all(names=SOURCES + HOST_SOURCES) -> Dict[str, str]:
    """Build every library of ``names`` that is missing, in parallel; return
    the compiler's output per source built (empty when everything was built
    already)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = (cxx_command if name in HOST_SOURCES else nvcc_command)(name,
                                                                      tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"building {_source(name).name} exited "
                          f"{proc.returncode}:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``csrc/<name>.cpp``,
    built first if needed. Thread-safe: the Loader's threads may ask for
    the codec at once, and only one of them builds it."""
    with _lock:
        if name not in _loaded:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
