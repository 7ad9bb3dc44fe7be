"""Builds the port's CUDA kernel libraries with ``nvcc``.

Each source under ``selavi_tpu_torch/csrc/`` is compiled for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes`` by
its wrapper module. The library lands in ``build/selavi_tpu_torch/`` at
the root of the checkout as ``lib<source stem>_<hash>.so``, keyed by the
source's content hash, so an edited source is rebuilt and an unchanged one
is reused. Nothing is built at import time: a wrapper builds its library
at its first launch.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "selavi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built")


def build_library(source: Path) -> Path:
    """Compile ``source`` into a shared library (cached by the source's
    content hash) and return its path."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out
