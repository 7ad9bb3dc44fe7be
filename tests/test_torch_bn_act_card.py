"""The eval-mode BatchNorm + residual + ReLU kernel (``csrc/bn_act.cu``)
on the card.

Marked ``card``: each test skips without a CUDA device. On a machine with
one, from the root of a checkout:

    python -m pytest -q -m card tests/test_torch_bn_act_card.py

Tolerance of the kernel against ``bn_act_plain`` (the ATen composition),
``experiments/bn_act.py::TOLERANCE``: in bf16 one bf16 ulp (``bf16_ulps``)
of the largest magnitude among the two results and, beside a residual,
the BatchNorm's own output; in fp32 a few 2^-23 of the terms' magnitude
(``fp32_ulps``, ``term_scale``). The kernel computes ``x * s + t (+ r)`` in fp32 with one
fused multiply-add and rounds once; ATen computes ``(x - mean) * invstd *
w + b`` in fp32, rounds, adds and rounds again.
"""

import pytest
import torch

from selavi_tpu_torch.experiments.bn_act import (
    AUDIO_CFG,
    TOLERANCE,
    bn_calls,
    chunked_ulps,
    inputs,
)
from selavi_tpu_torch.models.common import BN_EPS
from selavi_tpu_torch.models.r2plus1d import R2Plus1D18
from selavi_tpu_torch.models.resnet_audio import AudioResNet
from selavi_tpu_torch.ops import bn_act as ba

pytestmark = pytest.mark.card

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bn_act kernel runs only there")
    return torch.device("cuda", 0)


def _call(shape, relu, residual, layout="channels_fastest"):
    return {"shape": list(shape), "relu": relu, "residual": residual,
            "layout": layout}


def _check(x, res, params, relu):
    before = ba.launches
    y = ba.bn_act(x, *params, BN_EPS, relu, res)
    torch.cuda.synchronize()
    assert ba.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.stride() == x.stride()
    ref = ba.bn_act_plain(x, *params, BN_EPS, relu, res)
    assert chunked_ulps(x, res, params, relu, y, ref) <= TOLERANCE[x.dtype]
    assert torch.equal(ba.bn_act(x, *params, BN_EPS, relu, res), y)


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["bn", "res"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape", [
    (45, 3, 9, 11), (64, 2, 5, 7), (144, 3, 4, 5), (230, 2, 3, 3),
    (921, 1, 2, 3),            # 5D channels_last_3d
    (64, 13, 7), (45, 5, 9),   # 4D channels_last
    (921,), (3,), (2048,),     # [N, C]; C under a vector's width
])
def test_kernel_matches_plain(cuda, shape, dtype, residual, relu):
    gen = torch.Generator(device=cuda).manual_seed(len(shape) + shape[0])
    x, res, params = inputs(_call(shape, relu, residual), 3, cuda, gen,
                            dtype)
    _check(x, res, params, relu)


def test_kernel_matches_plain_at_every_tower_shape_at_batch_128(cuda):
    """The SK step's BatchNorm calls (video and audio towers, as ``encode``
    makes them) at the benchmark's batch of 128: the grid's walk and the
    running channel over tensors up to 1.73e9 elements."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    for call in bn_calls(cuda):
        x, res, params = inputs(call, 128, cuda, gen)
        _check(x, res, params, call["relu"])
        del x, res
        torch.cuda.empty_cache()


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["bn", "res"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("shape", [
    (64, 129, 50), (128, 33, 13), (512, 9, 4), (3, 8, 8),  # 4D NCHW
    (45, 3, 4, 5), (16, 2, 3, 3),                          # 5D NCDHW
])
def test_planar_kernel_matches_plain(cuda, shape, dtype, residual, relu):
    """Contiguous NCHW and NCDHW maps: planes of 6450, 429, 36, 64, 60
    and 18 positions, most not a whole number of vectors."""
    gen = torch.Generator(device=cuda).manual_seed(len(shape) + shape[0])
    x, res, params = inputs(_call(shape, relu, residual, "planar"), 3, cuda,
                            gen, dtype)
    assert x.is_contiguous() and ba.layout(x) == "planar"
    _check(x, res, params, relu)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_planar_kernel_takes_a_misaligned_view(cuda, dtype):
    """NCHW x, residual and y off a 16-byte boundary: every plane on
    the one-a-lane path."""
    n, c, h, w = 3, 64, 9, 8
    base = torch.randn(2, n * c * h * w + 1, device=cuda).to(dtype)
    x = base[0, 1:].view(n, c, h, w)
    res = base[1, 1:].view(n, c, h, w)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = inputs(_call((c,), True, False), 1, cuda, gen)[2]
    _check(x, res, params, True)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_kernel_takes_a_misaligned_view(cuda, dtype):
    """x, the residual and y 2 or 4 bytes off a 16-byte boundary: every
    element on the one-a-thread path."""
    c, n = 45, 1000
    base = torch.randn(2, n * c + 1, device=cuda).to(dtype)
    x, res = base[0, 1:].view(n, c), base[1, 1:].view(n, c)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = inputs(_call((c,), True, False), 1, cuda, gen)[2]
    _check(x, res, params, True)


def test_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, _, params = inputs(_call((64, 2, 3, 4), False, False), 2, cuda, gen)
    before = ba.launches
    with pytest.raises(ValueError, match="fastest"):
        ba.bn_act(x.transpose(2, 3), *params, BN_EPS, False)
    with pytest.raises(ValueError, match="residual"):
        ba.bn_act(x, *params, BN_EPS, False, x.contiguous())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ba.bn_act(x.half(), *params, BN_EPS, False)
    with pytest.raises(ValueError, match="residual"):
        ba.bn_act(x, *params, BN_EPS, False, x.float())
    with pytest.raises(ValueError, match="parameters"):
        ba.bn_act(x, *(p.double() for p in params), BN_EPS, False)
    wide = torch.zeros(2, ba.MAX_CHANNELS + 8, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        ba.bn_act(wide, *(torch.ones(ba.MAX_CHANNELS + 8, device=cuda),) * 4,
                  BN_EPS, False)
    assert ba.launches == before


def test_tower_routes_eval_only(cuda):
    """R(2+1)D-18 under bf16 autocast: 37 launches an eval forward without
    gradients, none in training or with the parameters' gradients needed;
    the pooled features close to those of the ops the layer runs
    otherwise."""
    model = R2Plus1D18(generator=torch.Generator().manual_seed(0)).to(cuda)
    video = torch.randn(2, 8, 56, 56, 3, device=cuda)
    model.eval()
    ba.reset_launches()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        fused = model(video)
    assert ba.launches == 37
    with torch.autocast("cuda", dtype=torch.bfloat16):
        plain = model(video)  # eval, gradients needed: the separate ops
        model.train()
        with torch.no_grad():
            model(video)
    assert ba.launches == 37
    cos = torch.nn.functional.cosine_similarity(fused, plain.detach())
    assert bool((cos > 0.999).all())


def test_audio_tower_routes_eval_only(cuda):
    """ResNet-9 on spectrograms as the card's log-mel hands them over (a
    transposed view, so the tower runs NCHW): 12 launches an eval forward
    without gradients, none in training; the features close to those of
    the separate ops."""
    from selavi_tpu_torch.train.step import prepare_audio

    model = AudioResNet("resnet9", torch.Generator().manual_seed(0)).to(cuda)
    pcm = torch.randn(2, AUDIO_CFG["samplerate"], device=cuda)
    spec = prepare_audio(pcm, audio_cfg=AUDIO_CFG)
    model.eval()
    ba.reset_launches()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        fused = model(spec)
    assert ba.launches == 12
    with torch.autocast("cuda", dtype=torch.bfloat16):
        plain = model(spec)  # eval, gradients needed: the separate ops
        model.train()
        with torch.no_grad():
            model(spec)
    assert ba.launches == 12
    cos = torch.nn.functional.cosine_similarity(fused, plain.detach())
    assert bool((cos > 0.999).all())
