"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes) and loaded with `ctypes`. Libraries live under
`build/repro_torch_kernels/` at the repository root, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads at once. Nothing is built when a module is imported: the first
launch builds (or `build_all()` does, started up front). `sm_count` is
the device's SM count, which the wrappers' split rules fill.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_attention", "mla_attention", "gatekeeper_loss",
           "deferral_entropy", "flash_attention", "wkv_scan")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels are "
            f"built from source on the machine that runs them")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def compile_source(name: str) -> Path:
    """Compile csrc/<name>.cu unless its hashed library exists. The nvcc
    log (with -Xptxas -v register and shared-memory counts) is written
    beside the library."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent build sees all or none
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            _libs[name] = lib
        return lib


def build_all() -> List[Path]:
    """Compile every source at once (one nvcc process each, in parallel)."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(compile_source, SOURCES))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`: the unit the split rules fill."""
    return torch.cuda.get_device_properties(index).multi_processor_count
