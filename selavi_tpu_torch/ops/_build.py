"""Builds the port's native libraries: CUDA kernels with ``nvcc``, the
host data runtime with ``g++``.

Each source under ``selavi_tpu_torch/csrc/`` is compiled for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes`` by
its wrapper module. The library lands in ``build/selavi_tpu_torch/`` at
the root of the checkout as ``lib<source stem>_<hash>.so``, keyed by the
source's content hash, so an edited source is rebuilt and an unchanged one
is reused. Nothing is built at import time: a wrapper builds its library
at its first launch.

``build_host_library`` compiles a C++ host source
(``selavi_tpu_torch/native/data_runtime.cpp``) with the JAX package's g++
flags. ``-march=native`` output only runs on CPUs like the one that built
it, so its key is the source hash and the host (``host_key``).
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "selavi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# selavi_tpu/native/__init__.py's flags; -lpthread follows the source
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


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


def host_key() -> str:
    """The machine and a hash of the CPU's model and feature flags: two
    hosts with the same key accept the same ``-march=native`` code."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        cpu = "".join(sorted(set(lines)))
    except OSError:  # not Linux: the processor name is all there is
        cpu = platform.processor()
    return (f"{platform.machine()}_"
            f"{hashlib.sha256(cpu.encode()).hexdigest()[:8]}")


def _compile(source: Path, out: Path, cmd_head: list, cmd_tail=()) -> Path:
    """Run ``cmd_head -o <tmp> source cmd_tail`` and move the result to
    ``out``: concurrent processes (loader workers, a second job) may race
    to build, and each writes its own temporary file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd_head, "-o", str(tmp), str(source), *cmd_tail]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{cmd[0]} not found: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}) on "
            f"{source.name}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _digest(source: Path) -> str:
    return hashlib.sha256(source.read_bytes()).hexdigest()[:12]


def build_library(source: Path) -> Path:
    """Compile ``source`` into a shared library (cached by the source's
    content hash) and return its path."""
    out = BUILD_DIR / f"lib{source.stem}_{_digest(source)}.so"
    if out.exists():
        return out
    return _compile(source, out, [nvcc(), *NVCC_FLAGS])


def build_host_library(source: Path) -> Path:
    """Compile the C++ host source ``source`` with g++ (cached by the
    source's content hash and ``host_key()``) and return its path. Raises
    ``RuntimeError`` when g++ is missing or fails."""
    out = BUILD_DIR / f"lib{source.stem}_{_digest(source)}_{host_key()}.so"
    if out.exists():
        return out
    return _compile(source, out, ["g++", *GXX_FLAGS], ["-lpthread"])
