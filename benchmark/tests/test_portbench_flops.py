"""The yardstick's FLOP and byte counts against counts by hand."""

import torch

from benchmark import flops
from benchmark.reference.model import Conv, Heads


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Conv(3, 4, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.temporal = Conv(4, 8, (3, 1, 1), (1, 1, 1), (1, 0, 0))
        self.heads = Heads(2, 8, 5, hidden=6)

    def forward(self, x):
        x = self.temporal(self.stem(x)).mean(dim=(2, 3, 4))
        return self.heads.eval()(x)


def test_count_matches_hand_count():
    with torch.device("meta"):
        net = TinyNet()
        x = torch.empty(2, 3, 4, 10, 10)
    got = flops.count(net, x)
    # stem: out [2, 4, 4, 5, 5], 3 inputs x 9 taps a MAC each
    stem = 2 * (2 * 4 * 4 * 5 * 5) * 3 * 9
    # temporal: out [2, 8, 4, 5, 5], 4 inputs x 3 taps
    temporal = 2 * (2 * 8 * 4 * 5 * 5) * 4 * 3
    # heads: 2 rows x 2 heads x (8 x 6 + 6 x 5)
    heads = 2 * 2 * 2 * (8 * 6 + 6 * 5)
    assert got == {"forward": stem + temporal + heads, "stems": stem}


def test_clip_flops_train_is_three_forwards_less_the_stems():
    cfg = dict(vid_base_arch="r2plus1d_18", aud_base_arch="resnet9",
               headcount=10, mlp_dim=309, num_frames=30, train_crop_size=112,
               aud_spec_type=2)
    got = flops.clip_flops(cfg, flops.spec_frames(1, 24000))
    # the video stem alone: out [45, 30, 56, 56], 3 x 49 taps; the audio
    # stem: out [64, 129, 50] of a 257 x 99 spectrogram, 49 taps
    video_stem = 2 * 45 * 30 * 56 * 56 * 3 * 49
    audio_stem = 2 * 64 * 129 * 50 * 49
    assert got["train"] == 3 * got["forward"] - video_stem - audio_stem
    # within 3% of the 451 GFLOP that XLA's cost analysis gave
    assert abs(got["train"] / 451.05e9 - 1) < 0.03


def test_spec_frames_and_sk_bytes():
    assert flops.spec_frames(1, 48000) == 99
    assert flops.spec_frames(1, 24000) == 99
    assert flops.spec_frames(1, 16000) == 99
    n, k = 2048, 309
    assert flops.sk_iteration_bytes(n, k) == (
        n * k * 4 + 4 * (2 * k + n) + 4 * (k + n + 1))
    assert flops.sk_iteration_bytes(n, k, 2) < flops.sk_iteration_bytes(n, k)
