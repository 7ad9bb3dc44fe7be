"""AVModel: the two-tower audio-visual network with stacked heads
(``selavi_tpu/models/av_model.py``).

``forward(video [B,T,H,W,3], audio [B,F,T,C])`` (C = ``audio_channels``:
1, or 2 for dual_data) returns per-head logits
``(logits_v, logits_a)``, each ``[H, B, K]``, or the pooled features
``(feat_v [B,512], feat_a [B,D_a])`` with ``return_features=True``. Train
or eval behaviour follows ``model.train()`` / ``model.eval()``; train-mode
dropout draws from the ``generator`` argument (for the global batch under
data parallelism, ``shard``). ``encode``,
``encode_video``, ``encode_audio`` and ``video_feature_map`` (the pre-GAP
map that retrieval pools) give the towers' outputs alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from selavi_tpu_torch.models.heads import HeadStack
from selavi_tpu_torch.models.r2plus1d import VIDEO_FEATURE_DIM, R2Plus1D18
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS, AudioResNet


class AVModel(nn.Module):
    def __init__(self, vid_base_arch: str = "r2plus1d_18",
                 aud_base_arch: str = "resnet9", use_mlp: bool = True,
                 headcount: int = 1, num_classes: int = 256,
                 midplanes_mode: str = "parity",
                 generator: Optional[torch.Generator] = None,
                 audio_channels: int = 1):
        super().__init__()
        if vid_base_arch != "r2plus1d_18":
            raise ValueError(f"unsupported video arch: {vid_base_arch!r}")
        g = generator if generator is not None else torch.Generator()
        self.video_network = R2Plus1D18(midplanes_mode, g)
        self.audio_network = AudioResNet(aud_base_arch, g, audio_channels)
        self.heads_v = HeadStack(headcount, VIDEO_FEATURE_DIM, num_classes,
                                 use_mlp=use_mlp, generator=g)
        self.heads_a = HeadStack(headcount, AUDIO_ARCHS[aud_base_arch][2],
                                 num_classes, use_mlp=use_mlp, generator=g)

    def forward(self, video, audio, return_features: bool = False,
                generator: Optional[torch.Generator] = None,
                shard: tuple[int, int] = (0, 1)):
        """``shard = (rank, world)``: dropout masks drawn for the global
        batch, of which this rank keeps its rows (``heads.dropout``)."""
        feat_v = self.video_network(video)
        feat_a = self.audio_network(audio)
        if return_features:
            return feat_v, feat_a
        return (self.video_heads(feat_v, generator, shard),
                self.audio_heads(feat_a, generator, shard))

    def encode(self, video, audio):
        """Pooled features of both modalities ``(feat_v, feat_a)``."""
        return self(video, audio, return_features=True)

    def encode_video(self, video):
        return self.video_network(video)

    def encode_audio(self, audio):
        return self.audio_network(audio)

    def video_feature_map(self, video):
        """Pre-GAP video feature map ``[B, t, h, w, 512]`` in fp32."""
        return self.video_network(video, return_map=True)

    def video_heads(self, feat_v, generator=None, shard=(0, 1)):
        """All video heads on pooled features [B, 512] -> [H, B, K]."""
        return self.heads_v(feat_v, generator, shard)

    def audio_heads(self, feat_a, generator=None, shard=(0, 1)):
        """All audio heads on pooled features [B, D_a] -> [H, B, K]."""
        return self.heads_a(feat_a, generator, shard)


def load_model(vid_base_arch: str = "r2plus1d_18",
               aud_base_arch: str = "resnet9", use_mlp: bool = True,
               headcount: int = 1,
               num_classes: int = 256, midplanes_mode: str = "parity",
               seed: int = 0, device=None, audio_channels: int = 1,
               **_unused) -> AVModel:
    """Build an AVModel with weights drawn from ``seed`` and move it to
    ``device`` (the card unless ``device="cpu"`` is given). Its audio stem
    takes ``audio_channels`` spectrograms (2 for dual_data)."""
    from selavi_tpu_torch.device import resolve_device

    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = AVModel(vid_base_arch, aud_base_arch, use_mlp, headcount,
                    num_classes, midplanes_mode, generator=g,
                    audio_channels=audio_channels)
    return model.to(device)
