"""Weights made by the benchmark from ``--seed``: on the card, in one call
to a ``torch.Generator`` there, in float32 (the type the system keeps its
parameters in under bf16 autocast).

Every parameter of the reference network is a slice of one normal draw,
scaled by the rule of the top-level module that holds it (``draw_std``):
a tower's own rule (``reference/towers``; the convolutional towers'
kernels by ``sqrt(2 / fan_out)``, kaiming fan out), and the heads' dense
kernels and last bias by ``1 / sqrt(3 * fan_in)`` (the spread of torch's
Linear default). A leaf whose rule gives 0 keeps its constant: BatchNorm
scales 1 and shifts 0, running means 0 and variances 1.

The same state dict is loaded into the system under test (by name, every
key of both sides, each shape checked) and into the reference.
"""

from __future__ import annotations

import torch


def make_state(net, seed, device):
    """The state dict of ``net`` (the reference ``Network``) drawn from
    ``seed`` on ``device``."""
    state = {k: v.detach().to(device).clone()
             for k, v in net.state_dict().items()}
    stds = {f"{top}.{k}": module.draw_std(k, v.shape)
            for top, module in net.named_children()
            for k, v in module.named_parameters()}
    drawn = [k for k, std in stds.items() if std != 0.0]
    total = sum(state[k].numel() for k in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    off = 0
    for k in drawn:
        t = state[k]
        t.copy_(flat[off:off + t.numel()].view_as(t) * stds[k])
        off += t.numel()
    return state


def load_into(module, state):
    """Copy ``state`` into ``module`` in place; its keys and shapes must be
    the state's, every one."""
    own = module.state_dict()
    if set(own) != set(state):
        missing = sorted(set(state) - set(own))[:5]
        extra = sorted(set(own) - set(state))[:5]
        raise ValueError(f"state dicts differ: missing {missing}, "
                         f"extra {extra}")
    with torch.no_grad():
        for k, v in own.items():
            if v.shape != state[k].shape:
                raise ValueError(f"{k}: {tuple(v.shape)} against "
                                 f"{tuple(state[k].shape)}")
            v.copy_(state[k])
