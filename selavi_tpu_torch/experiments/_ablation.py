"""What the kernel ablations share: ``ptxas -v`` reports of a kernel source
(``csrc/conv3x3.cu`` unless another is named) and builds of its variants
(the source with a few lines edited), loaded in place of the library of
its wrapper module (``ops.conv3x3`` unless another is named) for a
``with using(lib):`` block.
"""

from __future__ import annotations

import contextlib
import hashlib
import subprocess
from pathlib import Path

from selavi_tpu_torch.ops import _build
from selavi_tpu_torch.ops import conv3x3 as conv


def ptxas_report(kernel: str, source=None) -> str:
    """``ptxas -v`` lines of every entry of ``source`` (by default
    ``csrc/conv3x3.cu``; another path, such as an earlier commit's copy of
    it, gives that version's report) whose name holds ``kernel`` (each
    instance of a template), from a build with the library's flags; with
    them any warning that ptxas gave about it."""
    source = Path(source or conv.SOURCE)
    tag = hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:8]
    out = _build.BUILD_DIR / "ablation" / f"ptxas_{kernel}_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(source)], capture_output=True, text=True, check=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    starts = [i for i, line in enumerate(lines)
              if "Compiling entry" in line and kernel in line]
    if not starts:
        raise RuntimeError(f"ptxas compiled no entry named like {kernel}")
    # ptxas gives its performance warnings (such as wgmma serialized) as
    # "info" lines that name the function.
    warnings = [line for line in lines if kernel in line and (
        "warning" in line.lower() or "Performance Loss" in line)]
    return "\n".join(warnings + [line for i in starts
                                  for line in lines[i:i + 4]])


def build_variant(name: str, edits, ops=conv):
    """The source of wrapper module ``ops`` (``ops.SOURCE``) with the (text,
    replacement) ``edits`` of variant ``name``, built and loaded by
    ``ops.load_library``."""
    text = ops.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"{ops.SOURCE.name}")
        text = text.replace(old, new)
    source = _build.BUILD_DIR / "ablation" / f"{ops.SOURCE.stem}_{name}.cu"
    source.parent.mkdir(parents=True, exist_ok=True)
    source.write_text(text)
    return ops.load_library(_build.build_library(source))


@contextlib.contextmanager
def using(lib, ops=conv):
    """Wrapper module ``ops`` launches through ``lib`` inside the block."""
    saved, ops._lib = ops._lib, lib
    try:
        yield
    finally:
        ops._lib = saved
