"""Which cuDNN kernels run R(2+1)D's temporal (3,1,1) convolutions at the
stem's and layer1's shapes in the bf16 train step, on the card.

    python -m selavi_tpu_torch.experiments.temporal_conv

The traced train step (``chip_smoke.py``) finds an fp32 FFMA cuDNN forward
kernel (``..._fprop_implicit_gemm_indexed_f32f32_...``) under those convs.
This captures each conv's input as the model hands it over (a forward of
the full-width model under bf16 autocast, batch 24, 30x112x112), prints
its dtype and memory layout, and then runs the conv alone: under bf16
autocast as the model calls it, and on inputs cast to bf16 by hand in
NCDHW and in channels_last_3d, each with ``cudnn.benchmark`` off and on.
For each it prints the kernels that the profiler saw and the ms per call
(CUDA events). It needs a card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.measure import card_description, cuda_ms
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.ops.preprocess import normalize_video


def layout(x: torch.Tensor) -> str:
    if x.is_contiguous():
        return "NCDHW"
    if x.is_contiguous(memory_format=torch.channels_last_3d):
        return "channels_last_3d"
    return f"strides {tuple(x.stride())}"


def captured_inputs(device, batch: int = 24):
    """{name: (input, conv module)} of the stem's and layer1's temporal
    convs, from one forward of the full-width towers under bf16
    autocast."""
    model = load_model(headcount=10, num_classes=309, seed=0, device=device)
    model.train()
    video = model.video_network
    convs = {"stem temporal": video.stem_temporal,
             "layer1 temporal": video.layer1_block0.conv1.temporal}
    got = {}
    for name, conv in convs.items():
        conv.register_forward_pre_hook(
            lambda mod, inp, name=name: got.setdefault(name, inp[0].detach()))
    gen = torch.Generator(device=device).manual_seed(0)
    clips = torch.randint(0, 256, (batch, 30, 112, 112, 3),
                          dtype=torch.uint8, device=device, generator=gen)
    audio = torch.randn(batch, 257, 99, 1, device=device, generator=gen)
    with torch.no_grad(), torch.autocast(device.type, dtype=torch.bfloat16):
        model(normalize_video(clips), audio, return_features=True)
    return {name: (got[name], conv) for name, conv in convs.items()}


def kernels_of(fn) -> list:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def main() -> None:
    device = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_description()}", flush=True)
    for name, (x, conv) in captured_inputs(device).items():
        w = conv.weight.detach()
        print(f"{name}: input {list(x.shape)} {str(x.dtype)[6:]} "
              f"{layout(x)}, weight {list(w.shape)} {str(w.dtype)[6:]}",
              flush=True)
        kw = dict(stride=conv.stride, padding=conv.padding)

        def autocast_call(x=x, w=w):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return F.conv3d(x, w, **kw)

        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        xcl = xb.contiguous(memory_format=torch.channels_last_3d)
        wcl = wb.contiguous(memory_format=torch.channels_last_3d)
        variants = {
            "autocast, as the model calls it": autocast_call,
            "bf16 NCDHW": lambda: F.conv3d(xb.contiguous(), wb, **kw),
            "bf16 channels_last_3d": lambda: F.conv3d(xcl, wcl, **kw),
        }
        for benchmark in (False, True):
            torch.backends.cudnn.benchmark = benchmark
            for label, fn in variants.items():
                ms = cuda_ms(fn, reps=20)
                print(f"  {label}, cudnn.benchmark {benchmark}: {ms:.4f} ms; "
                      f"output {str(fn().dtype)[6:]}; kernels "
                      f"{[k[:100] for k in kernels_of(fn)]}", flush=True)
        torch.backends.cudnn.benchmark = False


if __name__ == "__main__":
    main()
