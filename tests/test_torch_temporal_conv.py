"""The temporal (3,1,1) conv of the port (``ops/temporal_conv.py``,
``models/r2plus1d.py::TemporalConv3d``) on the CPU.

``temporal_conv_plain`` spells out the kernel's arithmetic: three shifted
frame windows, each a matmul over channels. It is held against
``F.conv3d`` at the tower's 17 (C, Co, stride, T) shapes of both midplanes
modes, at batch 2 and a 2 x 3 plane. Tolerances: fp64 1e-12 and fp32 1e-5
of the output's largest magnitude, the same products summed over K = 3 C <=
3456 terms in another order. The gradients go through the autograd
Function, whose backward is ``aten.convolution_backward`` with conv3d's
arguments: equal to conv3d's own gradients.

The card's tests of the kernel are in ``test_torch_temporal_conv_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.models.r2plus1d import (
    R2Plus1D18,
    TemporalConv3d,
    temporal_conv_shapes,
)
from selavi_tpu_torch.ops import temporal_conv as tc

torch.set_num_threads(1)

SHAPES = [(mode, name, c, co, stride, t)
          for mode in ("parity", "aligned")
          for name, c, co, stride, t, _, _ in temporal_conv_shapes(mode)]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _conv3d(x, w, stride):
    return F.conv3d(x, w, None, (stride, 1, 1), (1, 0, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("mode,name,c,co,stride,t", SHAPES,
                         ids=[f"{s[0]}-{s[1]}" for s in SHAPES])
def test_plain_and_function_match_conv3d(mode, name, c, co, stride, t,
                                         dtype):
    g = torch.Generator().manual_seed(c * 7 + co + t)
    x = torch.randn(2, c, t, 2, 3, generator=g, dtype=dtype)
    w = torch.randn(co, c, 3, 1, 1, generator=g, dtype=dtype) * c ** -0.5
    ref = _conv3d(x, w, stride)
    y = tc.temporal_conv_plain(x, w, stride)
    assert y.dtype == dtype and y.shape == ref.shape
    assert y.shape[2] == tc.out_frames(t, stride)
    scale = ref.abs().max().item()
    assert (y - ref).abs().max().item() <= TOL[dtype] * scale

    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = tc.TemporalConvFunction.apply(xf, wf, stride)
    assert torch.equal(out, y)
    gy = torch.randn(ref.shape, generator=g, dtype=dtype)
    out.backward(gy)
    _conv3d(xr, wr, stride).backward(gy)
    assert torch.equal(xf.grad, xr.grad)
    assert torch.equal(wf.grad, wr.grad)


@pytest.mark.parametrize("t,stride", [(15, 2), (1, 1), (2, 2), (4, 1)])
def test_plain_pads_both_ends_with_zero_frames(t, stride):
    """Output frame 0 reads frames -1, 0, 1 and the last reads past T: the
    plain version (and so the kernel's reference) gives conv3d's zeros
    there, in fp64 to the last bits."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 45, t, 2, 2, generator=g, dtype=torch.float64)
    w = torch.randn(64, 45, 3, 1, 1, generator=g, dtype=torch.float64)
    y = tc.temporal_conv_plain(x, w, stride)
    torch.testing.assert_close(y, _conv3d(x, w, stride), rtol=1e-12,
                               atol=1e-12)
    # frame 0 sees only taps 1 and 2: tap 0 multiplies the zero frame -1
    head = torch.einsum("bchw,oc->bohw", x[:, :, 0], w[:, :, 1, 0, 0])
    if t > 1:
        head = head + torch.einsum("bchw,oc->bohw", x[:, :, 1],
                                   w[:, :, 2, 0, 0])
    torch.testing.assert_close(y[:, :, 0], head, rtol=1e-12, atol=1e-12)


def test_temporal_conv_shapes_follow_the_model():
    """The shape list matches the tower's modules and the inputs they are
    handed (a forward at 6 x 32 x 32)."""
    for mode in ("parity", "aligned"):
        model = R2Plus1D18(mode, torch.Generator().manual_seed(0)).eval()
        convs = [(n, m) for n, m in model.named_modules()
                 if isinstance(m, TemporalConv3d)]
        seen = {}
        for n, m in convs:
            m.register_forward_pre_hook(
                lambda mod, args, n=n: seen.update({n: args[0].shape}))
        with torch.no_grad():
            model(torch.randn(1, 6, 32, 32, 3))
        shapes = temporal_conv_shapes(mode, frames=6, size=32)
        assert len(shapes) == len(convs) == 17
        for (n, m), (name, c, co, stride, t, h, w) in zip(convs, shapes):
            assert n == name
            assert tuple(m.weight.shape) == (co, c, 3, 1, 1)
            assert m.stride == (stride, 1, 1) and m.padding == (1, 0, 0)
            assert tuple(seen[n]) == (1, c, t, h, w)


def test_temporal_conv3d_keeps_the_conv3d_state_dict():
    """TemporalConv3d has nn.Conv3d's parameter names and shapes, so the
    .pth import, checkpoints and DDP see no change."""
    model = R2Plus1D18("parity", torch.Generator().manual_seed(0))
    for name, m in model.named_modules():
        if isinstance(m, TemporalConv3d):
            ref = nn.Conv3d(m.in_channels, m.out_channels, (3, 1, 1),
                            m.stride, (1, 0, 0), bias=False)
            assert isinstance(m, nn.Conv3d)
            assert {k: v.shape for k, v in m.state_dict().items()} == \
                {k: v.shape for k, v in ref.state_dict().items()}, name
    assert isinstance(model.stem_temporal, TemporalConv3d)
    assert isinstance(model.layer3_block0.conv1.temporal, TemporalConv3d)


def test_jax_converted_tower_loads_strictly_into_the_temporal_convs():
    jmodel = jax_load_model(headcount=2, num_classes=8)
    video, audio = jnp.zeros((1, 4, 32, 32, 3)), jnp.zeros((1, 40, 51, 1))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        video, audio, train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)
    model = load_model(headcount=2, num_classes=8, device="cpu")
    load_jax_variables(model, variables["params"],
                       variables.get("batch_stats", {}))
    stem = variables["params"]["video_network"]["stem_temporal"]["conv"][
        "kernel"]
    torch.testing.assert_close(
        model.video_network.stem_temporal.weight,
        torch.from_numpy(np.transpose(np.asarray(stem), (4, 3, 0, 1, 2))),
        rtol=0, atol=0)


def test_module_runs_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    plain = tc.temporal_conv_plain
    monkeypatch.setattr(tc, "temporal_conv_plain",
                        lambda *a: calls.append(a[2]) or plain(*a))
    conv = TemporalConv3d(20, 16, 2, torch.Generator().manual_seed(1))
    x = torch.randn(2, 20, 5, 3, 3)
    y = conv(x)
    assert calls == [2]
    torch.testing.assert_close(y, _conv3d(x, conv.weight, 2), rtol=1e-5,
                               atol=1e-5)
    assert tc.launches == 0


def test_module_casts_as_autocast_does_on_the_cpu():
    """Under CPU bf16 autocast the module casts x and w to bf16, as
    autocast's conv does, and rounds its fp32 sums once: within one bf16
    ulp of the conv3d that autocast runs."""
    conv = TemporalConv3d(45, 64, 1, torch.Generator().manual_seed(2))
    x = torch.randn(2, 45, 4, 3, 3)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = conv(x)
        ref = _conv3d(x, conv.weight, 1)
    assert y.dtype == ref.dtype == torch.bfloat16
    exact = tc.temporal_conv_plain(x.bfloat16().double(),
                                   conv.weight.bfloat16().double(), 1)
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(1e-3)))
                     - 7)
    assert ((y.double() - exact).abs() <= ulp).all()
    assert ((ref.double() - exact).abs() <= ulp).all()


@pytest.mark.parametrize("bad,match", [
    (dict(kernel=(2, 1, 1)), "w must be"),
    (dict(kernel=(3, 3, 3)), "w must be"),
    (dict(stride=3), "stride"),
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(layout="ncdhw"), "channels_last_3d"),
    (dict(co=60), "multiple of 8"),
])
def test_kernel_wrapper_refuses_without_launching(monkeypatch, bad, match):
    """On a device other than the CPU the wrapper checks what the kernel
    takes before it builds or launches anything (the ``meta`` device stands
    in for the card here)."""
    def no_launch():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tc, "_library", no_launch)
    dtype = bad.get("dtype", torch.bfloat16)
    x = torch.empty(2, 64, 6, 4, 4, dtype=dtype, device="meta")
    if bad.get("layout") != "ncdhw":
        x = x.contiguous(memory_format=torch.channels_last_3d)
    w = torch.empty(bad.get("co", 64), 64, *bad.get("kernel", (3, 1, 1)),
                    dtype=dtype, device="meta")
    with pytest.raises((ValueError, TypeError), match=match):
        tc.temporal_conv(x, w, bad.get("stride", 1))
    assert tc.launches == 0


def test_cpu_wrapper_checks_shapes():
    x = torch.randn(1, 8, 4, 2, 2)
    with pytest.raises(ValueError, match="stride"):
        tc.temporal_conv(x, torch.randn(8, 8, 3, 1, 1), 3)
    with pytest.raises(ValueError, match="w must be"):
        tc.temporal_conv(x, torch.randn(8, 4, 3, 1, 1), 1)


def test_model_module_has_no_other_conv_changes():
    """Only the temporal convs changed class: the spatial, downsample and
    stem spatial convs stay nn.Conv3d."""
    model = R2Plus1D18("parity", torch.Generator().manual_seed(0))
    kinds = {type(m) for n, m in model.named_modules()
             if isinstance(m, nn.Conv3d) and not n.endswith("temporal")}
    assert kinds == {nn.Conv3d}
