"""Where the time of the bf16 wgmma forward goes, on the card.

    python -m selavi_tpu_torch.experiments.fwd_ablation

As ``wgrad_ablation`` does for the weight gradient, this times
``conv_fwd_wgmma`` of ``csrc/conv3x3.cu`` with parts of its main loop
taken out, at the conv probe's bench shape ``[480, 56, 56, 64] -> 128`` in
bf16: the forward (its BN = 128 instance) and the data gradient (BN = 64,
C = 128 -> Co = 64). Each variant is the source with a few lines edited,
built with the library's ``nvcc`` flags, and timed twice in turns
(A B C ... C B A) beside cuDNN's forward and data gradient. The variants
compute wrong results on purpose: their times are all they are for. It
also prints the ``ptxas -v`` report of the unedited kernel. It needs a
card.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.experiments.conv3x3 import (
    BENCH_SHAPE,
    library_conv3x3,
    library_dgrad,
)
from selavi_tpu_torch.experiments.wgrad_ablation import (
    build_variant,
    ptxas_report,
    using,
)
from selavi_tpu_torch.measure import card_description, cuda_ms
from selavi_tpu_torch.ops import conv3x3 as conv

# Without the copies of later stages, nothing waits for them either.
COPIES = ("    if (producer && s + kFwdAhead < total) issue(s + kFwdAhead);\n"
          "    mbar_wait(full + 8 * (s % kFwdStages), s / kFwdStages & 1);\n")
LDMATRIX = ("        ldmatrix_x4(a[dx][k], row + (((2 * k + k_half) ^ phase)"
            " << 4));\n")
WGMMA = ("        wgmma_rs<BN>(acc, a[dx][k], desc_mn_sw128(b + k * 2048),\n"
         "                     rem > 0 || dx > 0 || k > 0);\n")
# The stores stay in the code (or ptxas drops the products whose results
# nothing reads) behind a test that fails for every box.
STORES = ("        if (co0 + 64 * box < co)\n", "        if (co < 0)\n")
SMEM_A = ("        if constexpr (BN == 128)\n"
          "          wgmma_m64n128k16_tt(acc, "
          "desc_mn_sw128(stage + k * 2048),\n"
          "                              desc_mn_sw128(b + k * 2048));\n"
          "        else\n" + WGMMA)
# name -> (text of the source, its replacement) edits
VARIANTS = {
    "full": (),
    "no_stores": (STORES,),
    "no_copies": ((COPIES, ""),),
    "no_ldmatrix": ((LDMATRIX, ""),),
    "no_wgmma": ((WGMMA, ""),),
    "wgmma_only": ((COPIES, ""), (LDMATRIX, ""), STORES),
    # wgmma_only with A read from the ring by a shared-memory descriptor
    # instead of from registers (the forward's BN = 128 only).
    "wgmma_only_smem_a": ((COPIES, ""), (LDMATRIX, ""), STORES,
                          (WGMMA, SMEM_A)),
    "copies_only": ((LDMATRIX, ""), (WGMMA, ""), STORES),
    "stores_only": ((COPIES, ""), (LDMATRIX, ""), (WGMMA, "")),
}


def main() -> dict:
    device = resolve_device(None)
    if device.type != "cuda":
        raise RuntimeError("the ablation times the card: it needs a CUDA "
                           "device")
    print(f"card: {card_description()}", flush=True)
    print(ptxas_report("conv_fwd_wgmma"), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda name: build_variant(f"fwd_{name}", VARIANTS[name]),
            VARIANTS)))

    n, h, wd, c, co = BENCH_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, h, wd, c, generator=gen, device=device).bfloat16()
    w = (0.1 * torch.randn(3, 3, c, co, generator=gen,
                           device=device)).bfloat16()
    g = torch.randn(n, h, wd, co, generator=gen, device=device).bfloat16()
    cases = {"forward": lambda: conv.conv3x3(x, w),
             "dgrad": lambda: conv.conv3x3_dgrad(g, w)}
    times = {(case, name): [] for case in cases for name in VARIANTS}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        with using(libs[name]):
            for case, fn in cases.items():
                times[(case, name)].append(cuda_ms(fn))
    library = {"forward": cuda_ms(lambda: library_conv3x3(x, w)),
               "dgrad": cuda_ms(lambda: library_dgrad(g, w))}
    for (case, name), ms in times.items():
        print(f"ablation {case} {name} {BENCH_SHAPE} bfloat16: "
              f"{' / '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
    for case, ms in library.items():
        print(f"ablation cuDNN {case} {BENCH_SHAPE} bfloat16: {ms:.4f} ms",
              flush=True)
    return {"times": times, "library_ms": library}


if __name__ == "__main__":
    main()
