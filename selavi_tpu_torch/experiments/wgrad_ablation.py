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

from concurrent.futures import ThreadPoolExecutor

import torch

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.experiments._ablation import (
    build_variant,
    ptxas_report,
    using,
)
from selavi_tpu_torch.experiments.conv3x3 import BENCH_SHAPE, library_wgrad
from selavi_tpu_torch.measure import card_description, cuda_ms
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


def main() -> dict:
    device = resolve_device(None)
    if device.type != "cuda":
        raise RuntimeError("the ablation times the card: it needs a CUDA "
                           "device")
    print(f"card: {card_description()}", flush=True)
    print(ptxas_report("conv_wgrad_wgmma"), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda name: build_variant(f"wgrad_{name}", VARIANTS[name]),
            VARIANTS)))

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
