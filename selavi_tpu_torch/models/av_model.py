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

On a process grid (``grid``, ``parallel/mesh.py``) the forward is
``towers`` then ``heads``: each rank's pooled features are gathered over
its model group, and the rank's own slice of the head stacks runs on its
data row's rows; its logits are ``[H / M, B * M, K]``. The towers, and
``encode``, are as without a grid. The eval tools build the model without
one: every head on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from selavi_tpu_torch.models.heads import HeadStack, shard_rows
from selavi_tpu_torch.models.r2plus1d import VIDEO_FEATURE_DIM, R2Plus1D18
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS, AudioResNet


class AVModel(nn.Module):
    def __init__(self, vid_base_arch: str = "r2plus1d_18",
                 aud_base_arch: str = "resnet9", use_mlp: bool = True,
                 headcount: int = 1, num_classes: int = 256,
                 midplanes_mode: str = "parity",
                 generator: Optional[torch.Generator] = None,
                 audio_channels: int = 1, grid=None):
        super().__init__()
        if vid_base_arch != "r2plus1d_18":
            raise ValueError(f"unsupported video arch: {vid_base_arch!r}")
        g = generator if generator is not None else torch.Generator()
        self.grid = grid
        heads = {} if grid is None else {"owned": grid.heads(headcount),
                                         "bn_group": grid.data_group}
        self.video_network = R2Plus1D18(midplanes_mode, g)
        self.audio_network = AudioResNet(aud_base_arch, g, audio_channels)
        self.heads_v = HeadStack(headcount, VIDEO_FEATURE_DIM, num_classes,
                                 use_mlp=use_mlp, generator=g, **heads)
        self.heads_a = HeadStack(headcount, AUDIO_ARCHS[aud_base_arch][2],
                                 num_classes, use_mlp=use_mlp, generator=g,
                                 **heads)

    def forward(self, video, audio, return_features: bool = False,
                generator: Optional[torch.Generator] = None,
                shard: tuple[int, int] = (0, 1)):
        """``shard = (rank, world)``: dropout masks drawn for the global
        batch, of which this rank keeps its rows (``heads.head_dropout``)."""
        feats = self.towers(video, audio)
        if return_features:
            return feats
        return self.heads(*feats, generator=generator, shard=shard)

    def towers(self, video, audio):
        """Pooled features ``(feat_v, feat_a)`` of this rank's rows."""
        return self.video_network(video), self.audio_network(audio)

    def heads(self, feat_v, feat_a, generator=None, shard=(0, 1)):
        """The owned heads' logits ``(logits_v, logits_a)`` on this rank's
        rows, ``shard = (rank, world)`` of the global batch; on a grid, on
        its data row's rows (``Grid.gather``)."""
        if self.grid is None:
            rows = shard_rows(feat_v.shape[0], shard, feat_v.device)
        else:
            rows = (self.grid.gathered_rows(feat_v.shape[0], feat_v.device),
                    feat_v.shape[0] * self.grid.world)
            # in the heads' dtype, so that the heads' gradients are summed
            # over the model group in it before the towers' dtype rounds
            # them, as one stack sums them
            dtype = self.heads_v.proj_weight.dtype
            feat_v = self.grid.gather(feat_v.to(dtype))
            feat_a = self.grid.gather(feat_a.to(dtype))
        return (self.heads_v(feat_v, generator, rows),
                self.heads_a(feat_a, generator, rows))

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
        """The owned video heads on pooled features [B, 512] -> [H, B, K]
        (no gather)."""
        return self.heads_v(feat_v, generator,
                            shard_rows(feat_v.shape[0], shard, feat_v.device))

    def audio_heads(self, feat_a, generator=None, shard=(0, 1)):
        """The owned audio heads on pooled features [B, D_a] -> [H, B, K]
        (no gather)."""
        return self.heads_a(feat_a, generator,
                            shard_rows(feat_a.shape[0], shard, feat_a.device))


def load_model(vid_base_arch: str = "r2plus1d_18",
               aud_base_arch: str = "resnet9", use_mlp: bool = True,
               headcount: int = 1,
               num_classes: int = 256, midplanes_mode: str = "parity",
               seed: int = 0, device=None, audio_channels: int = 1,
               grid=None, **_unused) -> AVModel:
    """Build an AVModel with weights drawn from ``seed`` and move it to
    ``device`` (the card unless ``device="cpu"`` is given). Its audio stem
    takes ``audio_channels`` spectrograms (2 for dual_data). On a ``grid``
    it holds this rank's slice of the heads."""
    from selavi_tpu_torch.device import resolve_device

    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = AVModel(vid_base_arch, aud_base_arch, use_mlp, headcount,
                    num_classes, midplanes_mode, generator=g,
                    audio_channels=audio_channels, grid=grid)
    return model.to(device)
