"""Eval-mode BatchNorm, residual add and ReLU in one pass
(``ops/bn_act.py``, routed from ``models/common.py::FlaxBatchNorm``) on
the CPU.

``bn_act_plain`` is the composition the towers ran before, and CPU tensors
run it: bit for bit the old ops. The kernel's own arithmetic (``s =
weight / sqrt(var + eps)``, ``t = bias - mean * s``, ``x * s + t (+ r)``
in fp32, ReLU, one rounding) is spelled out here in torch and held to the
composition: bf16 results within one bf16 ulp
(``experiments/bn_act.py::bf16_ulps``: of the largest magnitude among the
two results and, beside a residual, the BatchNorm's own output, where the
composition's first rounding falls), fp32 results within
``TOLERANCE[float32]`` of 2^-23 of the terms' magnitude (``fp32_ulps``,
``term_scale``), which a result rounded through bf16 misses by far.
The towers in eval mode give the outputs of their old call sites bit for
bit; in training, or where a gradient is needed, the layer never reaches
``bn_act``. The card's tests are in ``test_torch_bn_act_card.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from selavi_tpu_torch.experiments.bn_act import (
    TOLERANCE,
    bf16_ulps,
    fp32_ulps,
    term_scale,
)
from selavi_tpu_torch.models.common import (
    BN_EPS,
    FlaxBatchNorm,
    flax_batch_norm,
)
from selavi_tpu_torch.models.r2plus1d import R2Plus1D18
from selavi_tpu_torch.models.resnet_audio import AudioResNet
from selavi_tpu_torch.ops import bn_act as ba

torch.set_num_threads(1)

SPATIAL = {5: (3, 4, 5), 4: (6, 7), 2: ()}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _inputs(ndim, c, dtype, residual, seed=0, batch=2):
    g = torch.Generator().manual_seed(seed)
    shape = (batch, c, *SPATIAL[ndim])

    def draw():
        return (torch.randn(shape, generator=g) * 2).to(dtype).contiguous(
            memory_format=ba.FORMATS[ndim])

    x = draw()
    r = draw() if residual else None
    params = (1 + 0.3 * torch.randn(c, generator=g),
              0.3 * torch.randn(c, generator=g),
              0.3 * torch.randn(c, generator=g),
              0.5 + torch.rand(c, generator=g))
    return x, r, params


def _composition(x, r, params, relu):
    w, b, m, v = params
    y = F.batch_norm(x, m, v, w, b, training=False, eps=BN_EPS)
    if r is not None:
        y = y + r
    return F.relu(y) if relu else y


def _kernel_math(x, r, params, relu):
    """csrc/bn_act.cu's arithmetic in torch: fp32 s and t, the sum in
    fp32, ReLU, one rounding to x's dtype."""
    w, b, m, v = params
    s = w / torch.sqrt(v + BN_EPS)
    t = b - m * s
    shape = [1, -1] + [1] * (x.dim() - 2)
    y = x.float() * s.view(shape) + t.view(shape)
    if r is not None:
        y = y + r.float()
    if relu:
        y = F.relu(y)
    return y.to(x.dtype)


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["bn", "res"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("ndim", [5, 4, 2])
def test_plain_is_the_old_composition(ndim, dtype, residual, relu):
    x, r, params = _inputs(ndim, 45, dtype, residual)
    y = ba.bn_act_plain(x, *params, BN_EPS, relu, r)
    assert torch.equal(y, _composition(x, r, params, relu))
    # a CPU tensor runs the plain version, and counts no launch
    before = ba.launches
    assert torch.equal(ba.bn_act(x, *params, BN_EPS, relu, r), y)
    assert ba.launches == before


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["bn", "res"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("c", [45, 64, 144, 230, 921])
@pytest.mark.parametrize("ndim", [5, 4])
def test_kernel_math_within_one_ulp_of_composition(ndim, c, dtype,
                                                   residual, relu):
    x, r, params = _inputs(ndim, c, dtype, residual, seed=c)
    ref = _composition(x, r, params, relu)
    y = _kernel_math(x, r, params, relu)
    assert y.dtype == dtype and y.stride() == x.stride()
    if dtype == torch.float32:
        assert fp32_ulps(y, ref, term_scale(x, r, params)) <= TOLERANCE[dtype]
        return
    w, b, m, v = params
    terms = () if r is None else (F.batch_norm(x, m, v, w, b, False,
                                               eps=BN_EPS),)
    assert bf16_ulps(y, ref, *terms) <= TOLERANCE[dtype]


@pytest.mark.parametrize("residual", [False, True], ids=["bn", "res"])
def test_fp32_measure_refuses_a_result_rounded_through_bf16(residual):
    """The fp32 tolerance tells an fp32 sum from one that went through
    bf16: the kernel's math passes it, the same math rounded to bf16 on
    the way misses it thousands of times over."""
    x, r, params = _inputs(5, 144, torch.float32, residual, seed=7)
    ref = _composition(x, r, params, True)
    scale = term_scale(x, r, params)
    y = _kernel_math(x, r, params, True)
    assert fp32_ulps(y, ref, scale) <= TOLERANCE[torch.float32]
    rounded = _kernel_math(x, r, params, True).bfloat16().float()
    assert fp32_ulps(rounded, ref, scale) > 1000 * TOLERANCE[torch.float32]


def test_one_rounding_differs_from_two_only_where_the_sum_cancels():
    """Where the residual cancels the BatchNorm term, the composition's
    rounding of that term (100.7 to 100.5) is many ulps of the result (0.5
    against the kernel's 0.7) and under one ulp of the term."""
    x = torch.tensor([[100.5, 2.0]], dtype=torch.bfloat16)
    r = torch.tensor([[-100.0, 0.0]], dtype=torch.bfloat16)
    params = (torch.ones(2), torch.tensor([0.2, 0.0]), torch.zeros(2),
              torch.ones(2))
    ref = _composition(x, r, params, False)
    y = _kernel_math(x, r, params, False)
    assert bf16_ulps(y, ref) > 1.0
    w, b, m, v = params
    bn = F.batch_norm(x, m, v, w, b, False, eps=BN_EPS)
    assert bf16_ulps(y, ref, bn) <= 1.0


def _old_bn(bn, x):
    return flax_batch_norm(x, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, bn.training)


def _old_r2p1d(m, video):
    """R2Plus1D18.forward as it called its BatchNorms before: the layer,
    then F.relu, then the residual add and F.relu at a block's end."""

    def conv2p1d(mod, x):
        return mod.temporal(F.relu(_old_bn(mod.bn_mid, mod.spatial(x))))

    x = video.permute(0, 4, 1, 2, 3)
    x = F.relu(_old_bn(m.stem_bn1, m.stem_spatial(x)))
    x = F.relu(_old_bn(m.stem_bn2, m.stem_temporal(x)))
    for stage in range(1, 5):
        for block in range(2):
            blk = getattr(m, f"layer{stage}_block{block}")
            out = F.relu(_old_bn(blk.bn1, conv2p1d(blk.conv1, x)))
            out = _old_bn(blk.bn2, conv2p1d(blk.conv2, out))
            residual = x if blk.downsample is None else _old_bn(
                blk.downsample.bn, blk.downsample.conv(x))
            x = F.relu(out + residual)
    return x.float().mean(dim=(2, 3, 4))


def _old_audio(m, spec):
    """AudioResNet.forward as it called its BatchNorms before: ReLU
    after each conv of a block but its last, then the residual add and
    F.relu."""

    def convbn(mod, x, relu):
        y = _old_bn(mod.bn, mod.conv(x))
        return F.relu(y) if relu else y

    x = convbn(m.stem, spec.permute(0, 3, 1, 2), True)
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for blk in m.blocks:
        convs = [blk.conv1, blk.conv2] + ([blk.conv3] if hasattr(
            blk, "conv3") else [])
        out = x
        for i, conv in enumerate(convs):
            out = convbn(conv, out, i < len(convs) - 1)
        residual = x if blk.downsample is None else convbn(blk.downsample,
                                                           x, False)
        x = F.relu(out + residual)
    return x.float().mean(dim=(2, 3))


def _randomize_bn(model, seed):
    """Non-trivial running statistics and affine parameters."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, FlaxBatchNorm):
                c = mod.weight.shape[0]
                mod.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                mod.bias.copy_(0.2 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.2 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))


TOWERS = {
    "r2plus1d18": (lambda g: R2Plus1D18(generator=g), _old_r2p1d,
                   (1, 4, 24, 24, 3), 37),
    "r2plus1d18-aligned": (lambda g: R2Plus1D18("aligned", generator=g),
                           _old_r2p1d, (2, 2, 16, 16, 3), 37),
    "resnet9": (lambda g: AudioResNet("resnet9", g), _old_audio,
                (2, 40, 30, 1), 12),
    "resnet50": (lambda g: AudioResNet("resnet50", g), _old_audio,
                 (1, 40, 24, 1), 53),
}


def _tower(name, seed=0):
    make, old, shape, bns = TOWERS[name]
    model = make(torch.Generator().manual_seed(seed))
    _randomize_bn(model, seed + 1)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 2))
    return model, old, x, bns


@pytest.mark.parametrize("name", TOWERS)
def test_tower_eval_equals_old_call_sites(name):
    """In fp32, as the port runs on the CPU. (Under CPU bf16 autocast the
    first forward of a process now and then gets NaN out of a finite
    input from ResNet-9's last stride-2 Conv2d, whichever call sites it
    runs: a fault of the CPU convolution, not of these ops.)"""
    model, old, x, _ = _tower(name)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), old(model, x))


@pytest.mark.parametrize("name", ["r2plus1d18", "resnet9"])
def test_tower_train_equals_old_call_sites(name):
    """Training runs the old ops in the old order: the output, the
    gradients and the running statistics' update, bit for bit."""
    model, old, x, _ = _tower(name)
    twin = _tower(name)[0]
    model.train()
    twin.train()
    y, y_old = model(x), old(twin, x)
    assert torch.equal(y, y_old)
    y.square().sum().backward()
    y_old.square().sum().backward()
    for (k, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(a.grad, b.grad), k


@pytest.mark.parametrize("name", TOWERS)
def test_layer_reaches_bn_act_only_in_eval_without_grad(name, monkeypatch):
    """The layer hands every BatchNorm to ``bn_act`` in eval mode under
    no_grad, whatever the tensor's layout (on the card the kernel takes it
    or raises), and none in training or where a gradient is needed;
    ``bn_act`` on the CPU runs the plain version, so the outputs stay bit
    for bit, and no launch is counted."""
    model, old, x, bns = _tower(name)
    calls = []
    real = ba.bn_act

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ba, "bn_act", spy)
    before = ba.launches
    model.eval()
    with torch.no_grad():
        y = model(x)
    assert len(calls) == bns
    assert torch.equal(y, old(model, x))
    calls.clear()
    model(x)  # eval with the parameters' gradients needed
    model.train()
    with torch.no_grad():
        model(x)  # training: batch statistics and their update
    assert calls == []
    assert ba.launches == before


@pytest.mark.parametrize("name", TOWERS)
def test_state_dict_keys_unchanged(name):
    """No parameter or buffer added or renamed: a BatchNorm holds weight,
    bias, running_mean and running_var, and the towers' key counts are
    those the converters and checkpoints know."""
    model = _tower(name)[0]
    keys = list(model.state_dict())
    counts = {"r2plus1d18": 185, "r2plus1d18-aligned": 185, "resnet9": 60,
              "resnet50": 265}
    assert len(keys) == counts[name]
    for mod_name, mod in model.named_modules():
        if isinstance(mod, FlaxBatchNorm):
            assert sorted(k for k, _ in mod.state_dict().items()) == [
                "bias", "running_mean", "running_var", "weight"], mod_name


@pytest.mark.parametrize("shape,fmt,fastest", [
    ((2, 45, 3, 4, 5), torch.channels_last_3d, True),
    ((2, 45, 3, 4, 5), torch.contiguous_format, False),
    ((2, 64, 6, 7), torch.channels_last, True),
    ((2, 64, 6, 7), torch.contiguous_format, False),
    ((5, 921), torch.contiguous_format, True),
    ((2, 8, 3), torch.contiguous_format, False),
])
def test_channels_fastest(shape, fmt, fastest):
    x = torch.empty(shape).contiguous(memory_format=fmt)
    assert ba.channels_fastest(x) is fastest
    # never the kernel on the CPU
    assert not ba.kernel_takes(x, (torch.ones(shape[1]),) * 4)


@pytest.mark.parametrize("shape,fmt,kind", [
    ((2, 45, 3, 4, 5), torch.channels_last_3d, "channels_fastest"),
    ((2, 45, 3, 4, 5), torch.contiguous_format, "planar"),
    ((2, 64, 129, 50), torch.channels_last, "channels_fastest"),
    ((2, 64, 129, 50), torch.contiguous_format, "planar"),
    ((5, 921), torch.contiguous_format, "channels_fastest"),
    ((2, 1, 6, 7), torch.contiguous_format, "channels_fastest"),
    ((2, 8, 3), torch.contiguous_format, None),
])
def test_layout(shape, fmt, kind):
    """The kernel's two layouts; a single channel's tensor is both and
    counts as channels fastest; a 3D map is neither. A strided view of
    either is neither too."""
    x = torch.empty(shape).contiguous(memory_format=fmt)
    assert ba.layout(x) == kind
    if x.dim() >= 4:
        assert ba.layout(x.transpose(2, 3)) is None
        assert ba.layout(x[:, :, ::2]) is None


def test_kernel_args_refused_off_the_card():
    """``check_kernel_args`` names the device of a tensor off the card."""
    x, _, params = _inputs(4, 64, torch.bfloat16, False)
    with pytest.raises(ValueError, match="CUDA"):
        ba.check_kernel_args(x, params)
