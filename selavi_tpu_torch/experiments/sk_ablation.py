"""Where the time of the fused SK kernel goes, on the card.

    python -m selavi_tpu_torch.experiments.sk_ablation [--parent PATH]

Times ``csrc/fused_sk.cu::sk_iteration`` at VGG-Sound scale (170752 x 309)
in fp32 and bf16 with parts of its design taken out or changed, each
variant twice in turns (A B C ... C B A). Each variant is the source with a
few lines edited, built with the library's ``nvcc`` flags: the ring with no
math (``copies_only``), the math on whatever the ring holds, with no bulk
copies (``math_only``), one row in flight a warp (``one_row``), the
cross-block merge as a second kernel (``two_launches``), ``expf`` for the
bulk exps (``accurate_exp``), a ring that fills a block's shared memory
(``deep_ring``: 7 stages in bf16, as many as fit) and the
column pairs rescaled only when their max moves by more than 60
(``lazy_rescale``). The
first two compute wrong results on purpose; the others must agree with the
full kernel, and the script prints how far they do. ``--parent`` names an
earlier ``fused_sk.cu`` with the two-kernel interface of its first design
(e.g. the parent commit's, unpacked by ``git archive`` into the git-ignored
``build/``): it is built and timed in the same turns. It prints the
``ptxas -v`` report of the K=309 instances of the kernel (and of the
earlier one), and the SM clock that ``nvidia-smi`` reads while the full
kernel runs back to back. It needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.experiments._ablation import (
    build_variant,
    ptxas_report,
    using,
)
from selavi_tpu_torch.measure import card_description, cuda_ms, sm_clocks
from selavi_tpu_torch.ops import _build
from selavi_tpu_torch.ops import sinkhorn_fused as sf

N, K = 170752, 309
# The K=309 instances (10 columns a lane) of the kernel and of the first
# design's row kernel, as their mangled names spell them.
KERNELS = {torch.float32: "IfLi10E", torch.bfloat16: "I13__nv_bfloat16Li10E"}
# Every tile takes the path of a warp with no rows: wait, release.
COPIES_ONLY = (("      if (nw == RPW) {\n", "      if (false) {\n"),
               ("      } else if (nw > 0) {\n", "      } else if (false) {\n"))
# The producer arrives with no bulk copy.
MATH_ONLY = (("        if (bulk > 0) {\n", "        if (false) {\n"),)
# The running column pairs rescaled only when a group's max passes theirs
# by more than 60 (terms up to e^60 stay far inside fp32): one warp-wide
# test, and no rescale exp in most groups.
LAZY_RESCALE = (("""      float nmax = cmax[c];
#pragma unroll
      for (int i = 0; i < F; ++i) nmax = fmaxf(nmax, v[i][c]);
      csum[c] = csum[c] > 0.f ? csum[c] * exp_of(cmax[c] - nmax) : 0.f;
      cmax[c] = nmax;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < F; ++i) s += exp_from(v[i][c], nmax);
      csum[c] += s;
    }
""", """      tmax[c] = v[0][c];
#pragma unroll
      for (int i = 1; i < F; ++i) tmax[c] = fmaxf(tmax[c], v[i][c]);
      moved |= tmax[c] > cmax[c] + 60.f;
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float nmax = fmaxf(cmax[c], tmax[c]);
        csum[c] = csum[c] > 0.f ? csum[c] * exp_of(cmax[c] - nmax) : 0.f;
        cmax[c] = nmax;
      }
    }
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < F; ++i) s += exp_from(v[i][c], cmax[c]);
      csum[c] += s;
    }
"""), ("""    // then the sum.
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
""", """    // then the sum.
    bool moved = false;
    float tmax[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
"""))
VARIANTS = {
    "full": (),
    "copies_only": COPIES_ONLY,
    "math_only": MATH_ONLY,
    "one_row": (("constexpr int kInFlightCap = 4;",
                 "constexpr int kInFlightCap = 1;"),),
    "two_launches": (("constexpr bool kTicket = true;",
                      "constexpr bool kTicket = false;"),),
    "accurate_exp": (("constexpr bool kFastExp = true;",
                      "constexpr bool kFastExp = false;"),),
    "deep_ring": (("constexpr int kRingBytes = 96 * 1024;",
                   "constexpr int kRingBytes = 232192;"),),
    "lazy_rescale": LAZY_RESCALE,
}
WRONG_ON_PURPOSE = ("copies_only", "math_only")


def load_parent(path: Path):
    """An earlier ``fused_sk.cu`` (the first design: rows kernel, then a
    finalize kernel over 256-row blocks' partials), built, and a function
    that runs one iteration through it with its scratch made once."""
    lib = ctypes.CDLL(str(_build.build_library(path)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sk_fused_iteration.argtypes = [ptr, i32] + [ptr] * 9 + [i32] * 4 + [ptr]
    lib.sk_fused_iteration.restype = i32
    rows_per_block = 256

    def iteration(m, log_alpha, log_beta, log_r, out):
        n, k = m.shape
        blocks = math.ceil(n / rows_per_block)
        scratch = torch.empty(2 * k * blocks + blocks, device=m.device)

        def run():
            rc = lib.sk_fused_iteration(
                m.data_ptr(), int(m.dtype == torch.bfloat16),
                log_alpha.data_ptr(), log_beta.data_ptr(), log_r.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                scratch.data_ptr(), scratch[k * blocks:].data_ptr(),
                scratch[2 * k * blocks:].data_ptr(), n, k, rows_per_block,
                blocks, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"the earlier kernel failed: {rc}")
        return run
    return iteration


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an earlier fused_sk.cu to time beside")
    args = parser.parse_args(argv)
    device = resolve_device(None)
    if device.type != "cuda":
        raise RuntimeError("the ablation times the card: it needs a CUDA "
                           "device")
    print(f"card: {card_description()}", flush=True)
    with ThreadPoolExecutor(len(VARIANTS) + 4) as pool:
        reports = [pool.submit(ptxas_report, f"sk_iteration{tag}", sf.SOURCE)
                   for tag in KERNELS.values()]
        if args.parent:
            reports += [pool.submit(ptxas_report, f"sk_rows_kernel{tag}",
                                    args.parent) for tag in KERNELS.values()]
        builds = {name: pool.submit(build_variant, f"sk_{name}", edits, sf)
                  for name, edits in VARIANTS.items()}
        parent = pool.submit(load_parent, args.parent) if args.parent else None
        for future in reports:
            print(f"ptxas: {future.result()}", flush=True)
        libs = {name: future.result() for name, future in builds.items()}
        parent = parent.result() if parent else None

    gen = torch.Generator(device=device).manual_seed(7)
    log_ps = (torch.log_softmax(2 * torch.randn(N, K, generator=gen,
                                                device=device), 1)
              + torch.log_softmax(2 * torch.randn(N, K, generator=gen,
                                                  device=device), 1))
    log_r = torch.full((K,), -math.log(K), device=device)
    log_beta = torch.full((N,), -math.log(N), device=device)
    m32 = (10.0 * log_ps).contiguous()
    del log_ps
    log_alpha = log_r - torch.logsumexp(m32 + log_beta[:, None], 0)
    times, diffs = {}, {}
    for dtype in KERNELS:
        m = m32.to(dtype)
        out = (torch.empty(K, device=device), torch.empty(N, device=device),
               torch.empty((), device=device))
        ws = sf.make_workspace(m)
        fns = {}
        for name, lib in libs.items():
            def run(lib=lib):
                with using(lib, sf):
                    sf.fused_sk_iteration(m, log_alpha, log_beta, log_r,
                                          out=out, workspace=ws)
            fns[name] = run
        if parent:
            fns["parent"] = parent(m, log_alpha, log_beta, log_r, out)
        results = {}
        for name in list(fns) + list(fns)[::-1]:
            times.setdefault((dtype, name), []).append(
                cuda_ms(fns[name], reps=20))
            results.setdefault(name, tuple(t.clone() for t in out))
        # The SM clock under this load, read halfway through a second of
        # back-to-back iterations.
        with ThreadPoolExecutor(1) as pool:
            clock = pool.submit(lambda: (time.sleep(0.5), sm_clocks())[1])
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 1.0:
                for _ in range(100):
                    fns["full"]()
                torch.cuda.synchronize()
            print(f"SM clock while the full kernel runs ({str(dtype)[6:]}; "
                  f"clocks.sm, clocks.max.sm): {clock.result()}", flush=True)
        full = results["full"]
        for name, got in results.items():
            if name not in WRONG_ON_PURPOSE:
                diffs[(dtype, name)] = max(
                    float((a - b).abs().max()) for a, b in zip(got, full))
    for (dtype, name), ms in times.items():
        agree = diffs.get((dtype, name))
        note = "" if agree is None else f" (max |d| from full {agree:.3g})"
        print(f"ablation SK {name} {N}x{K} {str(dtype)[6:]}: "
              f"{' / '.join(f'{t:.4f}' for t in ms)} ms{note}", flush=True)
    return {"times": times, "diffs": diffs}


if __name__ == "__main__":
    main()
