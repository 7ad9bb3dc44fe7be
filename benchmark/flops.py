"""The yardstick: model FLOPs of a clip, bytes of an SK iteration, and the
card's published peaks.

FLOPs are 2 x the multiply-adds of every product (each convolution, the
heads' dense layers, and whatever a tower's own modules count: see
``reference/towers``), taken from the shapes of the benchmark's own plain
network (``reference/model.py``, its towers found by name) as it runs on
the ``meta`` device; BatchNorm, activations, pooling and the loss are not
counted. A training step costs three times the forward pass (the
forward, the input gradient and the weight gradient of every layer) less
the input gradient of the two stems, which no step computes. Nothing
recomputed is counted.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import Conv, Heads, Network

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, HBM3.
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def conv_flops(weight_shape, out_shape):
    """2 x MACs of a bias-free convolution, batch included."""
    cout, cin = weight_shape[:2]
    return 2 * math.prod(out_shape) * cin * math.prod(weight_shape[2:])


def dense_flops(rows, fan_in, fan_out, stacks=1):
    return 2 * rows * fan_in * fan_out * stacks


def count(net, *inputs):
    """``{"forward": F, "stems": S}``: the forward FLOPs of ``net`` on
    ``inputs`` and the part of them in the first product that each of its
    towers (its top-level modules) finishes, whose input gradient no step
    needs. The products are each ``Conv``, each ``Heads`` (no tower's
    stem) and each module with a method ``flops(args, out)``."""
    totals = {"forward": 0, "stems": 0}
    hooks, towers = [], set()

    def product_hook(name, flops_of):
        tower = name.split(".")[0] if "." in name else ""

        def hook(module, args, out):
            f = flops_of(args, out)
            totals["forward"] += f
            if tower not in towers:  # a tower's first product reads the input
                towers.add(tower)
                totals["stems"] += f
        return hook

    def heads_hook(module, args, out):
        h, d, hidden = module.hidden_weight.shape
        rows = args[0].shape[0]
        totals["forward"] += (dense_flops(rows, d, hidden, h)
                              + dense_flops(rows, hidden, out.shape[-1], h))

    for name, m in net.named_modules():
        if isinstance(m, Heads):
            hooks.append(m.register_forward_hook(heads_hook))
        elif isinstance(m, Conv):
            hooks.append(m.register_forward_hook(product_hook(
                name, lambda args, out, m=m: conv_flops(m.weight.shape,
                                                        out.shape))))
        elif hasattr(m, "flops"):
            hooks.append(m.register_forward_hook(product_hook(name, m.flops)))
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return totals


def clip_flops(flags, spec_frames):
    """``{"forward", "train"}`` FLOPs of one clip of a configuration's
    ``flags`` (the port's flag names, the towers' among them) with
    ``spec_frames`` spectrogram frames."""
    with torch.device("meta"):
        net = Network(flags["vid_base_arch"], flags["aud_base_arch"],
                      flags["headcount"], flags["mlp_dim"]).eval()
        t, c = flags["num_frames"], flags["train_crop_size"]
        nfilt = 40 if flags["aud_spec_type"] == 1 else 257
        video = torch.empty(1, t, c, c, 3)
        spec = torch.empty(1, nfilt, spec_frames, 1)
    n = count(net, video, spec)
    return {"forward": n["forward"],
            "train": 3 * n["forward"] - n["stems"]}


def sk_iteration_bytes(n, k, elem_bytes=4):
    """Bytes one Sinkhorn-Knopp iteration needs: ``M [n, k]`` read once,
    ``log_alpha [k]``, ``log_beta [n]`` and ``log_r [k]`` read once, the
    new ``log_alpha``, ``log_beta`` and the error written once (fp32)."""
    return n * k * elem_bytes + 4 * (2 * k + n) + 4 * (k + n + 1)


def spec_frames(seconds, samplerate):
    """Frames of a log-mel spectrogram: 20 ms windows every 10 ms."""
    flen = int(math.floor(0.02 * samplerate + 0.5))
    step = int(math.floor(0.01 * samplerate + 0.5))
    slen = seconds * samplerate
    return 1 if slen <= flen else 1 + math.ceil((slen - flen) / step)
