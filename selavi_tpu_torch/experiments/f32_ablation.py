"""Where the time of the fp32 conv kernels goes, on the card.

    python -m selavi_tpu_torch.experiments.f32_ablation

As ``fwd_ablation`` does for the bf16 forward, this times the fp32
forward kernels of ``csrc/conv3x3.cu`` (``conv_fwd_f32``, one tap a slice,
which the forward's 256 x 128 tile takes, and ``conv_fwd_f32_halo``, one
tap row a slice, which the dgrad's 256 x 64 tile takes) and
``conv_wgrad_f32`` with parts of their main loops taken out, and each
forward tile on the other design, at the conv probe's bench shape
``[480, 56, 56, 64] -> 128`` in fp32. Each variant is the source with a few
lines edited (an edit applies wherever its text stands: the two forward
kernels share lines), built with the library's ``nvcc`` flags, and timed
twice in turns (A B C ... C B A) beside cuDNN (TF32 off). The variants
compute wrong results on purpose: their times are all they are for. It
prints the ``ptxas -v`` report of the unedited kernels. It needs a card.
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
from selavi_tpu_torch.experiments.conv3x3 import (
    BENCH_SHAPE,
    library_conv3x3,
    library_dgrad,
    library_wgrad,
    tf32_off,
)
from selavi_tpu_torch.measure import card_description, cuda_ms
from selavi_tpu_torch.ops import conv3x3 as conv

KERNELS = ("conv_fwd_f32", "conv_wgrad_f32")
# Without the FMAs nothing reads the shared-memory loads either, so ptxas
# drops them too: what is left is the copies, barriers and stores.
FMA = ("                                        const float4& b1) {\n",
       "                                        const float4& b1) {\n"
       "  return;\n")
COPIES = (("    if (s + kStages - 1 < steps) issue((s + kStages - 1) % "
           "kStages);\n", ""),
          ("    if (s + kF32WgStages - 1 < steps) issue();\n", ""))
# The stores stay in the code (or ptxas drops the FMAs whose results
# nothing reads) behind a test that fails for every output.
STORES = (("    if (p >= m_total) continue;\n",
           "    if (m_total >= 0) continue;\n"),
          ("        if (co0 + col < copad)\n", "        if (copad < 0)\n"))
# The dx = 0 and dx = 2 taps read their halo rows with no test of the
# image-row ends: the forward's selects go, and the weight gradient reads no
# zero row (the compiler may then reuse each halo row's load for the three
# dx).
MASKS = (("          (first >> r) & 1 ? zs : xs + r * kF32WgRows);\n",
          "          xs + r * kF32WgRows);\n"),
         ("          (last >> r) & 1 ? zs : xs + (r + 2) * kF32WgRows);\n",
          "          xs + (r + 2) * kF32WgRows);\n"),
         ("            if (dx == 0 && (!ROW4 || i == 0) && "
          "(first[g] >> i & 1)) a = 0.f;\n", ""),
         ("            if (dx == 2 && (!ROW4 || i == 3) && "
          "(last[g] >> i & 1)) a = 0.f;\n", ""))
# Every kernel capped at 128 registers, so that two blocks fit on an SM.
TWO_BLOCKS = (("template <class Tile, bool VEC>\n"
               "__global__ void __launch_bounds__(kF32Threads, 1)",
               "template <class Tile, bool VEC>\n"
               "__global__ void __launch_bounds__(kF32Threads, 2)"),
              ("template <class Tile, bool VEC, bool ROW4>\n"
               "__global__ void __launch_bounds__(kF32Threads, 1)",
               "template <class Tile, bool VEC, bool ROW4>\n"
               "__global__ void __launch_bounds__(kF32Threads, 2)"),
              ("template <bool VEC>\n"
               "__global__ void __launch_bounds__(kF32Threads, 1)",
               "template <bool VEC>\n"
               "__global__ void __launch_bounds__(kF32Threads, 2)"))
# The slice loops unrolled u times (32: fully). The kernel unrolls the
# forward's fully and the weight gradient's 8 times.
FWD_LOOP = "    for (int k = 0; k < kF32Depth; ++k) {\n"
WGRAD_LOOP = "    for (int r = 0; r < kF32Depth; ++r) {\n"


def unrolled(u):
    pragma = "#pragma unroll" + (f" {u}" if u < 32 else "") + "\n"
    return (("#pragma unroll\n" + FWD_LOOP, pragma + FWD_LOOP),
            ("#pragma unroll 8\n" + WGRAD_LOOP, pragma + WGRAD_LOOP))


# Each forward tile on the other design: the forward's (Co > 64) on the
# halo, the dgrad's (Co <= 64) on one tap a slice.
HALO_WIDE = (("using F32FwdWide = F32FwdTile<256, 128, 4, false>;",
              "using F32FwdWide = F32FwdTile<256, 128, 4, true>;"),)
TAPS_NARROW = (("using F32FwdNarrow = F32FwdTile<256, 64, 2, true>;",
                "using F32FwdNarrow = F32FwdTile<256, 64, 2, false>;"),)
# name -> (text of the source, its replacement) edits
VARIANTS = {
    "full": (),
    "no_fma": (FMA,),
    "no_copies": COPIES,
    "no_stores": STORES,
    "no_masks": MASKS,
    "fma_only": COPIES + STORES,
    "copies_only": (FMA,) + STORES,
    "two_blocks": TWO_BLOCKS,
    "unroll_32": unrolled(32),
    "unroll_8": unrolled(8),
    "unroll_4": unrolled(4),
    "halo_wide": HALO_WIDE,
    "taps_narrow": TAPS_NARROW,
    "halo_wide_copies_only": HALO_WIDE + (FMA,) + STORES,
    "taps_narrow_copies_only": TAPS_NARROW + (FMA,) + STORES,
    "halo_wide_fma_only": HALO_WIDE + COPIES + STORES,
    "taps_narrow_fma_only": TAPS_NARROW + COPIES + STORES,
}


def main() -> dict:
    device = resolve_device(None)
    if device.type != "cuda":
        raise RuntimeError("the ablation times the card: it needs a CUDA "
                           "device")
    print(f"card: {card_description()}", flush=True)
    with ThreadPoolExecutor(len(VARIANTS) + len(KERNELS)) as pool:
        reports = [pool.submit(ptxas_report, kernel) for kernel in KERNELS]
        builds = {name: pool.submit(build_variant, f"f32_{name}", edits)
                  for name, edits in VARIANTS.items()}
        for future in reports:
            print(f"ptxas: {future.result()}", flush=True)
        libs = {name: future.result() for name, future in builds.items()}

    n, h, wd, c, co = BENCH_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, h, wd, c, generator=gen, device=device)
    w = 0.1 * torch.randn(3, 3, c, co, generator=gen, device=device)
    g = torch.randn(n, h, wd, co, generator=gen, device=device)
    cases = {"forward": lambda: conv.conv3x3(x, w),
             "dgrad": lambda: conv.conv3x3_dgrad(g, w),
             "wgrad": lambda: conv.conv3x3_wgrad(x, g)}
    times = {(case, name): [] for case in cases for name in libs}
    with tf32_off():
        for name in list(libs) + list(libs)[::-1]:
            with using(libs[name]):
                for case, fn in cases.items():
                    times[(case, name)].append(cuda_ms(fn, reps=20))
        library = {"forward": cuda_ms(lambda: library_conv3x3(x, w)),
                   "dgrad": cuda_ms(lambda: library_dgrad(g, w)),
                   "wgrad": cuda_ms(lambda: library_wgrad(x, g))}
    for (case, name), ms in times.items():
        print(f"ablation {case} {name} {BENCH_SHAPE} float32: "
              f"{' / '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
    for case, ms in library.items():
        print(f"ablation cuDNN {case} {BENCH_SHAPE} float32 (TF32 off): "
              f"{ms:.4f} ms", flush=True)
    return {"times": times, "library_ms": library}


if __name__ == "__main__":
    main()
