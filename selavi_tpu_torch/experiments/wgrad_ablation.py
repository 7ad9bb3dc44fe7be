"""Where the time of the bf16 wgmma weight gradient goes, on the card.

    python -m selavi_tpu_torch.experiments.wgrad_ablation

No profiler that sees inside a kernel runs on every card's host (``ncu``
and ``nsys`` may not), so this times ``conv_wgrad_wgmma`` of
``csrc/conv3x3.cu`` with parts of its main loop taken out, at the conv
probe's bench shape ``[480, 56, 56, 64] -> 128`` in bf16. Each variant is
the source with a few lines edited, built with the same ``nvcc`` flags,
and timed twice in turns (A B C ... C B A) beside cuDNN's weight gradient.
The variants compute wrong results on purpose: their times are all they
are for. It also prints the ``ptxas -v`` report of the unedited kernel
(registers, spills, shared memory). It needs a card.
"""

from __future__ import annotations

import contextlib
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.experiments.conv3x3 import BENCH_SHAPE, library_wgrad
from selavi_tpu_torch.measure import card_description, cuda_ms
from selavi_tpu_torch.ops import _build
from selavi_tpu_torch.ops import conv3x3 as conv

BUILD = "    if (s + 1 < steps) build(s + 1);\n"
COPIES = "    if (s + kWgAhead < steps) issue(s + kWgAhead);\n"
WGMMA = "k < kWgSlice / 16; ++k)"
# Warpgroup 1 copies g's columns 64..127: without them the copies move a
# third fewer bytes while warpgroups 0 and 2 issue as many as before.
G_COPIES = "    if (dx < 2) {\n"
# name -> (text of the source, its replacement) edits
VARIANTS = {
    "full": (),
    "no_build": ((BUILD, ""),),
    "no_copies": ((COPIES, ""),),
    "no_wgmma": ((WGMMA, "k < 0; ++k)"),),
    "wgmma_only": ((BUILD, ""), (COPIES, "")),
    "copies_only": ((BUILD, ""), (WGMMA, "k < 0; ++k)")),
    "copies_only_half_g": ((BUILD, ""), (WGMMA, "k < 0; ++k)"),
                           (G_COPIES, "    if (dx == 1) return;\n" + G_COPIES)),
}


def ptxas_report(kernel: str = "conv_wgrad_wgmma") -> str:
    """``ptxas -v`` lines of every entry of ``csrc/conv3x3.cu`` whose name
    holds ``kernel`` (each instance of a template), from a build with the
    library's flags; with them any warning that ptxas gave about it."""
    out = _build.BUILD_DIR / "ablation" / "ptxas_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(conv.SOURCE)], capture_output=True, text=True, check=True)
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


def build_variant(name: str, edits=None):
    """``csrc/conv3x3.cu`` with the (text, replacement) ``edits`` of variant
    ``name`` (by default this module's), built and loaded."""
    text = conv.SOURCE.read_text()
    for old, new in VARIANTS[name] if edits is None else edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"{conv.SOURCE.name}")
        text = text.replace(old, new)
    source = _build.BUILD_DIR / "ablation" / f"conv3x3_{name}.cu"
    source.parent.mkdir(parents=True, exist_ok=True)
    source.write_text(text)
    return conv.load_library(_build.build_library(source))


@contextlib.contextmanager
def using(lib):
    saved, conv._lib = conv._lib, lib
    try:
        yield
    finally:
        conv._lib = saved


def main() -> dict:
    device = resolve_device(None)
    if device.type != "cuda":
        raise RuntimeError("the ablation times the card: it needs a CUDA "
                           "device")
    print(f"card: {card_description()}", flush=True)
    print(ptxas_report(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))

    n, h, wd, c, co = BENCH_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, h, wd, c, generator=gen, device=device).bfloat16()
    g = torch.randn(n, h, wd, co, generator=gen, device=device).bfloat16()
    times = {name: [] for name in VARIANTS}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        with using(libs[name]):
            times[name].append(cuda_ms(lambda: conv.conv3x3_wgrad(x, g)))
    library_ms = cuda_ms(lambda: library_wgrad(x, g))
    for name, ms in times.items():
        print(f"ablation {name} {BENCH_SHAPE} bfloat16: "
              f"{' / '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
    print(f"ablation cuDNN weight gradient {BENCH_SHAPE} bfloat16: "
          f"{library_ms:.4f} ms", flush=True)
    return {"times": times, "library_ms": library_ms}


if __name__ == "__main__":
    main()
