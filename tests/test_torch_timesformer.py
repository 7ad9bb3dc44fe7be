"""The port's TimeSformer tower (``models/timesformer.py``) held to the
plain reference tower of the benchmark
(``benchmark/reference/towers/timesformer_base.py``: fp32, attention
written out, no fused kernel) on the CPU at a small size: 2 blocks of
width 64 and 4 heads, 4 frames of 32 x 32 px, batch 3, the same seeded
weights loaded into both (``benchmark/weights.py``).

Tolerances: both sides run in fp32 on the same weights and inputs; they
differ only in how sums are ordered (SDPA's kernel against an explicit
softmax, token layouts, the MLP's GEMMs), which moves a result by a few
fp32 ulps per layer: 1e-5 of the output's scale, about 20 times the
largest gap seen over five seeds (5.3e-7). The gradients pass through 2
blocks, ResNet-9's BatchNorms and the heads' BatchNorm, whose division by
a batch of 3's spread amplifies round-off: 3e-4 of the leaf's norm or the
median leaf's, whichever is larger, about 10 times the largest seen
(3.2e-5).
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import weights  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference.towers import timesformer_base as ref_tower  # noqa: E402,E501
from selavi_tpu_torch.config import parse_arguments  # noqa: E402
from selavi_tpu_torch.models import av_model  # noqa: E402
from selavi_tpu_torch.models.timesformer import TimeSformer  # noqa: E402
from selavi_tpu_torch.train.loop import Trainer  # noqa: E402
from selavi_tpu_torch.train.step import multihead_ce  # noqa: E402
from test_torch_slice import TINY, _dataset  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(dim=64, depth=2, heads=4, frames=4, size=32)
B, H, K = 3, 2, 8
FEATURE_TOL = 1e-5  # of the output's scale (module docstring)
GRAD_TOL = 3e-4  # of the median leaf's gradient norm (module docstring)
# load_model(...) state dicts, hashed by name, shape and value, as the
# tree before the tower table built them
R2P1D_DIGESTS = {
    (0, "resnet9"):
        "f48eac926aaaa903d7066948c0dc44fcd087ba8ed4f5518a5000ab1ebbb2a1fe",
    (7, "resnet50"):
        "5ac68c8bcce3dd9d45caff1150aaa50839a237cf2228d56ba72690374314a96c",
}


def port_tower(seed=0):
    return TimeSformer(torch.Generator().manual_seed(seed),
                       num_frames=SMALL["frames"], img_size=SMALL["size"],
                       dim=SMALL["dim"], depth=SMALL["depth"],
                       num_heads=SMALL["heads"])


def reference_tower():
    return ref_tower.Video(3, **SMALL)


class _Holder(torch.nn.Module):
    """A tower under the name the networks give it, for ``make_state``."""

    def __init__(self, tower):
        super().__init__()
        self.video_network = tower


def seeded_pair(seed=5):
    """The port's and the reference's small towers with one seeded state."""
    ref = reference_tower()
    state = weights.make_state(_Holder(ref), seed, "cpu")
    state = {k.split(".", 1)[1]: v for k, v in state.items()}
    port = port_tower()
    weights.load_into(port, state)
    weights.load_into(ref, state)
    return port, ref, state


def clips(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, SMALL["frames"], SMALL["size"], SMALL["size"], 3,
                       generator=g)


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("what", ["pooled", "map"])
def test_tower_matches_reference(what):
    """The pooled cls feature [B, 64] and the final-normed patch tokens
    [B, T, 2, 2, 64], eval mode."""
    port, ref, _ = seeded_pair()
    video = clips()
    with torch.no_grad():
        if what == "pooled":
            got, want = port.eval()(video), ref.eval()(video)
            assert got.shape == (B, SMALL["dim"])
        else:
            got = port.eval()(video, return_map=True)
            tokens = ref.eval().tokens(video)[:, 1:]
            t, side = SMALL["frames"], SMALL["size"] // 16
            want = tokens.reshape(B, side, side, t, -1).permute(0, 3, 1, 2, 4)
            assert got.shape == (B, t, side, side, SMALL["dim"])
    assert got.dtype == torch.float32
    assert _gap(got, want) < FEATURE_TOL


@pytest.fixture
def small_timesformer(monkeypatch):
    """``timesformer_base`` built at the small size wherever the port
    builds it by name."""
    monkeypatch.setitem(av_model.VIDEO_ARCHS, "timesformer_base",
                        lambda mode, g, frames, crop: TimeSformer(
                            g, num_frames=frames, img_size=crop,
                            dim=SMALL["dim"], depth=SMALL["depth"],
                            num_heads=SMALL["heads"]))


def networks(seed=9):
    """The port's AVModel (small TimeSformer, ResNet-9, MLP heads) and the
    reference Network with the same small tower, one seeded state in
    both."""
    net = ref_model.Network("timesformer_base", "resnet9", H, K)
    net.video_network = reference_tower()
    net.heads_v = ref_model.Heads(H, SMALL["dim"], K)
    state = weights.make_state(net, seed, "cpu")
    port = av_model.load_model("timesformer_base", "resnet9", headcount=H,
                               num_classes=K, device="cpu",
                               num_frames=SMALL["frames"],
                               crop_size=SMALL["size"])
    weights.load_into(port, state)
    weights.load_into(net, state)
    return port, net


def spectrograms(seed=1):
    return torch.randn(B, 40, 99, 1, generator=torch.Generator().manual_seed(
        seed))


def test_logits_through_avmodel_match_reference(small_timesformer):
    """Both towers and both head stacks, eval mode: the heads sized at the
    tower's width (64 here, 768 at full size)."""
    port, net = networks()
    assert port.heads_v.hidden_weight.shape == (H, SMALL["dim"], 512)
    video, spec = clips(), spectrograms()
    with torch.no_grad():
        got = port.eval()(video, spec)
        want = net.eval()(video, spec)
    for g, w in zip(got, want):
        assert _gap(g, w) < FEATURE_TOL


def _step(model, video, spec, labels, seed, port):
    """One train-mode forward and backward from a generator of ``seed``:
    the loss and every leaf's gradient."""
    gen = torch.Generator().manual_seed(seed)
    model.train()
    if port:
        logits_v, logits_a = model(video, spec, generator=gen)
        loss = 0.5 * multihead_ce(logits_v, labels) + 0.5 * multihead_ce(
            logits_a, labels)
    else:
        logits_v, logits_a = model(video, spec, gen)
        loss = 0.5 * ref_model.multihead_ce(
            logits_v, labels) + 0.5 * ref_model.multihead_ce(logits_a, labels)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads)), gen


def test_training_step_gradients_match_reference(small_timesformer):
    """The gradients of one training step, drop-path (the second block's
    rate is 0.1) and the heads' dropout drawn from one seeded generator
    on each side, in the same order; the generators end in the same
    state."""
    port, net = networks()
    video, spec = clips(), spectrograms()
    labels = torch.randint(0, K, (B, H), generator=torch.Generator()
                           .manual_seed(3))
    loss_p, grads_p, gen_p = _step(port, video, spec, labels, 11, True)
    loss_r, grads_r, gen_r = _step(net, video, spec, labels, 11, False)
    assert abs(loss_p - loss_r) < FEATURE_TOL * abs(loss_r)
    assert set(grads_p) == set(grads_r)
    norms = {k: float(v.norm()) for k, v in grads_r.items()}
    median = sorted(norms.values())[len(norms) // 2]
    gaps = {k: float((grads_p[k] - grads_r[k]).norm()) / max(norms[k], median)
            for k in grads_r}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < GRAD_TOL, (worst, gaps[worst])
    assert norms["video_network.blocks.1.temporal_fc.weight"] > 0
    assert torch.equal(gen_p.get_state(), gen_r.get_state())


def test_drop_path_draws_one_mask_a_sample_and_branch():
    """Rate 0 at the first block, 0.1 at the last; three masks a block of
    positive rate, each the global batch's draw of which a rank keeps its
    rows."""
    tower = port_tower().train()
    rates = [blk.drop_path for blk in tower.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1)
    blk = tower.blocks[1]
    whole = blk.masks(8, torch.Generator().manual_seed(4), (0, 1), "cpu")
    part = blk.masks(4, torch.Generator().manual_seed(4), (1, 2), "cpu")
    for w, p in zip(whole, part):
        assert torch.equal(w[1::2], p)
        assert ((w == 0) | torch.isclose(w, torch.tensor(1 / 0.9))).all()
    assert tower.blocks[0].masks(8, None, (0, 1), "cpu") == (None,) * 3


@pytest.mark.parametrize("temporal_fc", ["drawn", "zeroed"])
def test_the_check_needs_the_drawn_temporal_fc(temporal_fc):
    """With drop-path off and ``temporal_fc`` zeroed (the published
    initialisation of every block after the first), the temporal
    attention leaves the forward unchanged, so a check on such weights
    could not see it; drawn, it moves the output."""
    port, _, _ = seeded_pair()
    port.eval()
    if temporal_fc == "zeroed":
        with torch.no_grad():
            for blk in port.blocks:
                blk.temporal_fc.weight.zero_()
                blk.temporal_fc.bias.zero_()
    video = clips()
    with torch.no_grad():
        before = port(video)
        for blk in port.blocks:
            blk.temporal_attn.qkv.weight.mul_(-3.0)
        after = port(video)
    assert torch.equal(before, after) == (temporal_fc == "zeroed")


def test_counter_and_spans_a_forward():
    """Each block adds 2 to ``video.attn_calls`` and records its three
    spans, under a running profiler."""
    from torch.profiler import ProfilerActivity, profile

    from selavi_tpu_torch.utils import profiling

    port = port_tower().eval()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        port(clips())
    assert profiling.counters["video.attn_calls"] == 2 * SMALL["depth"]
    for name in ("video.temporal_attn", "video.spatial_attn", "video.mlp"):
        assert profiling.totals[name][0] == SMALL["depth"]
    profiling.reset()


@pytest.mark.parametrize("seed, audio", sorted(R2P1D_DIGESTS))
def test_r2plus1d_builds_as_before(seed, audio):
    """``--vid_base_arch r2plus1d_18``: the same names, shapes and seeded
    values as before the tower table."""
    model = av_model.load_model("r2plus1d_18", audio, headcount=2,
                                num_classes=16, seed=seed, device="cpu")
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == R2P1D_DIGESTS[seed, audio]
    assert model.heads_v.hidden_weight.shape[1] == 512


def test_full_size_tower_layout():
    """TimeSformer-Base at 8 x 224 x 224: 121.26 M parameters (no
    classifier), the published leaf names, 768-wide heads."""
    model = av_model.load_model("timesformer_base", "resnet9", headcount=2,
                                num_classes=16, device="cpu")
    tower = model.video_network
    assert sum(p.numel() for p in tower.parameters()) == 121_258_752
    assert tower.pos_embed.shape == (1, 197, 768)
    assert tower.time_embed.shape == (1, 8, 768)
    assert "blocks.11.temporal_attn.qkv.bias" in dict(
        tower.named_parameters())
    assert model.heads_v.hidden_weight.shape == (2, 768, 512)
    assert all(int(blk.temporal_fc.weight.count_nonzero()) == 0
               for blk in tower.blocks[1:])


@pytest.mark.parametrize("where", ["jax", "import", "export"])
def test_export_and_import_name_the_arch(where, small_timesformer):
    """The JAX package and the reference layout have no TimeSformer: the
    converters raise an error that names the arch."""
    from selavi_tpu_torch.models import convert
    from selavi_tpu_torch.train import torch_export, torch_import

    model = av_model.load_model("timesformer_base", "resnet9", headcount=2,
                                num_classes=4, device="cpu", num_frames=4,
                                crop_size=32)
    with pytest.raises(ValueError, match="timesformer_base"):
        if where == "jax":
            convert.export_jax_variables(model)
        elif where == "import":
            torch_import.port_state_from_reference(model, {})
        else:
            torch_export.model_for_state_dict(model.state_dict())


def test_trainer_trains_and_clusters_timesformer_features(
        small_timesformer, monkeypatch, tmp_path):
    """``--vid_base_arch timesformer_base`` through the Trainer: an epoch
    with an SK step at iteration 0 (matching included) over the tower's
    64-wide features (768 at full size)."""
    monkeypatch.chdir(tmp_path)
    args = parse_arguments().parse_args(
        TINY.split() + ["--vid_base_arch", "timesformer_base"])
    trainer = Trainer(args, _dataset(args), device="cpu")
    assert trainer.model.video_network.feature_dim == SMALL["dim"]
    history = trainer.fit()
    sk = [h for h in history if "sk_cost" in h]
    assert len(sk) == 1 and np.isfinite(sk[0]["sk_cost"])
    losses = [h["loss"] for h in history if "loss" in h]
    assert losses and np.isfinite(losses).all()


def test_attention_is_sdpa_of_the_written_out_softmax():
    """The port's attention against ``softmax(q k^T / sqrt(d)) v`` by head
    on the same qkv and proj weights."""
    from selavi_tpu_torch.models.timesformer import Attention

    torch.manual_seed(0)
    attn = Attention(64, 4)
    x = torch.randn(5, 7, 64)
    qkv = F.linear(x, attn.qkv.weight, attn.qkv.bias).view(5, 7, 3, 4, 16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    y = torch.softmax(q @ k.transpose(-2, -1) / 4.0, -1) @ v
    want = F.linear(y.transpose(1, 2).reshape(5, 7, 64), attn.proj.weight,
                    attn.proj.bias)
    with torch.no_grad():
        assert _gap(attn(x), want) < FEATURE_TOL
