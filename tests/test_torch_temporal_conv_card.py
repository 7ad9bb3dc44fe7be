"""The temporal (3,1,1) conv kernel (``csrc/temporal_conv.cu``) on the card.

Marked ``card``: each test skips without a CUDA device. On a machine with
one, from the root of a checkout:

    python -m pytest -q -m card tests/test_torch_temporal_conv_card.py

Tolerance of the kernel against ``temporal_conv_plain``: one bf16 ulp of
the output, elementwise. Both sum the same fp32 products in fp32 and round
once to bf16; the sums run in another order, so two roundings of nearly
equal fp32 sums may land one ulp apart. An ulp here is that of the larger
magnitude of the two, with a floor of 2^-8 of the output's largest
magnitude for sums that cancel to near zero (where the order's 1e-6
relative difference of the terms exceeds an ulp of the result).
"""

import pytest
import torch
import torch.nn.functional as F

from selavi_tpu_torch.models.r2plus1d import (
    TemporalConv3d,
    temporal_conv_shapes,
)
from selavi_tpu_torch.ops import temporal_conv as tc

pytestmark = pytest.mark.card

SHAPES = [(mode, *shape) for mode in ("parity", "aligned")
          for shape in temporal_conv_shapes(mode)]
BATCH = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the temporal conv kernel runs only "
                    "there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def bf16_ulp_excess(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max over elements of |y - ref| / (one bf16 ulp, as the module
    docstring defines it); at most 1 passes."""
    y, ref = y.float(), ref.float()
    mag = torch.maximum(y.abs(), ref.abs())
    floor = ref.abs().max() * 2.0 ** -8
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(mag, floor))) - 7)
    return ((y - ref).abs() / ulp).max().item()


def inputs(c, co, t, h, w, device, batch=BATCH, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, c, t, h, w, device=device, generator=g)
    wt = torch.randn(co, c, 3, 1, 1, device=device, generator=g) * c ** -0.5
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    return x, wt.to(torch.bfloat16)


@pytest.mark.parametrize("mode,name,c,co,stride,t,h,w", SHAPES,
                         ids=[f"{s[0]}-{s[1]}" for s in SHAPES])
def test_kernel_matches_plain(cuda, mode, name, c, co, stride, t, h, w):
    x, wt = inputs(c, co, t, h, w, cuda)
    before = tc.launches
    y = tc.temporal_conv(x, wt, stride)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    assert y.dtype == torch.bfloat16
    assert y.shape == (BATCH, co, tc.out_frames(t, stride), h, w)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    ref = tc.temporal_conv_plain(x, wt, stride)
    assert bf16_ulp_excess(y, ref) <= 1.0
    # a fixed order of sums: repeats are bit-identical
    assert torch.equal(tc.temporal_conv(x, wt, stride), y)


@pytest.mark.parametrize("name,c,co,stride,t,h,w",
                         temporal_conv_shapes("parity"),
                         ids=[s[0] for s in temporal_conv_shapes("parity")])
def test_kernel_matches_plain_at_batch_128(cuda, name, c, co, stride, t, h,
                                           w):
    """At the benchmark's batch of 128 clips: the blocks' walk over the
    items, the tensor maps' coordinates and the end of x as the cells run
    them."""
    x, wt = inputs(c, co, t, h, w, cuda, batch=128, seed=2)
    y = tc.temporal_conv(x, wt, stride)
    assert bf16_ulp_excess(y, tc.temporal_conv_plain(x, wt, stride)) <= 1.0


@pytest.mark.parametrize("c,co,stride,t,h,w", [
    (45, 64, 1, 7, 5, 9),     # cp.async path, resident weights
    (144, 64, 2, 15, 3, 3),   # TMA, resident, stride 2 at odd T
    (230, 128, 2, 15, 10, 10),  # cp.async, streamed, two pixel tiles
    (460, 256, 1, 3, 1, 1),   # one pixel a plane
    (921, 512, 2, 2, 2, 3),   # rows of 1842 bytes, T_out 1
    (8, 8, 1, 1, 9, 9),       # a single frame: both taps padding
])
def test_kernel_matches_plain_at_edges(cuda, c, co, stride, t, h, w):
    x, wt = inputs(c, co, t, h, w, cuda, batch=3, seed=1)
    y = tc.temporal_conv(x, wt, stride)
    assert bf16_ulp_excess(y, tc.temporal_conv_plain(x, wt, stride)) <= 1.0


def test_kernel_reads_an_offset_view(cuda):
    """x that starts 2 bytes into its storage: no TMA, the cp.async path."""
    c, co, t, h, w = 64, 64, 6, 8, 8
    base = torch.randn(2 * t * h * w * c + 1, device=cuda).to(torch.bfloat16)
    x = base[1:].view(2, t, h, w, c).permute(0, 4, 1, 2, 3)
    assert x.is_contiguous(memory_format=torch.channels_last_3d)
    wt = (torch.randn(co, c, 3, 1, 1, device=cuda) / 8).to(torch.bfloat16)
    y = tc.temporal_conv(x, wt, 1)
    assert bf16_ulp_excess(y, tc.temporal_conv_plain(x, wt, 1)) <= 1.0


@pytest.mark.parametrize("c,co,stride,t,hw", [
    (45, 64, 1, 30, 56), (144, 64, 1, 30, 56), (230, 128, 2, 30, 28),
    (1152, 512, 1, 4, 7)])
def test_module_matches_conv3d_under_autocast(cuda, c, co, stride, t, hw):
    """Forward and input/weight gradients of TemporalConv3d against the
    conv3d it replaces, both under bf16 autocast on fp32 x and weights. The
    backward runs the same library kernels on the same bf16 operands and
    gradient, with cuDNN made deterministic: equal."""
    torch.backends.cudnn.deterministic = True
    try:
        conv = TemporalConv3d(c, co, stride, torch.Generator()).to(cuda)
        x = torch.randn(2, c, t, hw, hw, device=cuda).contiguous(
            memory_format=torch.channels_last_3d)
        grads = []
        for fn in (conv, lambda v: F.conv3d(v, conv.weight, None,
                                            conv.stride, conv.padding)):
            xi = x.clone().requires_grad_()
            conv.weight.grad = None
            with torch.autocast("cuda", dtype=torch.bfloat16):
                y = fn(xi)
            g = torch.randn(y.shape, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(2)).to(y.dtype).contiguous(
                    memory_format=torch.channels_last_3d)
            y.backward(g)
            grads.append((y.detach(), xi.grad, conv.weight.grad.clone()))
        (y, gx, gw), (ry, rgx, rgw) = grads
        assert y.dtype == ry.dtype == torch.bfloat16
        assert bf16_ulp_excess(y, ry) <= 1.0
        assert torch.equal(gx, rgx)
        assert torch.equal(gw, rgw)
    finally:
        torch.backends.cudnn.deterministic = False


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, wt = inputs(64, 64, 4, 4, 4, cuda, batch=1)
    before = tc.launches
    with pytest.raises(ValueError, match="channels_last_3d"):
        tc.temporal_conv(x.contiguous(), wt, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        tc.temporal_conv(x.float(), wt.float(), 1)
    with pytest.raises(ValueError, match="stride"):
        tc.temporal_conv(x, wt, 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        tc.temporal_conv(x, wt[:60], 1)
    assert tc.launches == before
