"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, for
``sm_90a``, into ``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout. ``<hash>`` covers the source and the flags, so an edited source is
rebuilt at its first use and an unchanged one is loaded as it is. The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside the
library. Any failure raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    report: str          # nvcc's output: the -Xptxas -v lines
    seconds: float       # compile time; 0.0 when an earlier build was reused


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str, csrc: Path = CSRC) -> Built:
    """Compile ``<csrc>/<name>.cu`` unless its library exists already."""
    src = Path(csrc) / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"
    report = so.with_suffix(".ptxas.txt")
    if so.exists():
        return Built(name, so, report.read_text() if report.exists() else "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    report.write_text(proc.stdout)
    os.replace(tmp, so)            # atomic: a concurrent build sees all or nothing
    return Built(name, so, proc.stdout, time.perf_counter() - t0)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if need be."""
    return ctypes.CDLL(str(build(name).path))
