"""AVModel: the two-tower audio-visual network with stacked heads
(``selavi_tpu/models/av_model.py``).

The video tower is found by name in ``VIDEO_ARCHS`` (R(2+1)D-18, the
default, or TimeSformer-Base), the audio tower in ``AUDIO_ARCHS``; each
head stack is sized at its tower's ``feature_dim``.

``forward(video [B,T,H,W,3], audio [B,F,T,C])`` (C = ``audio_channels``:
1, or 2 for dual_data) returns per-head logits
``(logits_v, logits_a)``, each ``[H, B, K]``, or the pooled features
``(feat_v [B,D_v], feat_a [B,D_a])`` with ``return_features=True``. Train
or eval behaviour follows ``model.train()`` / ``model.eval()``; train-mode
dropout and drop-path draw from the ``generator`` argument (for the global
batch under data parallelism, ``shard``), the video tower's first.
``encode``, ``encode_video``, ``encode_audio`` and ``video_feature_map``
(the map before the pooling, which retrieval pools) give the towers'
outputs alone.

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
from selavi_tpu_torch.models.r2plus1d import R2Plus1D18
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS, AudioResNet
from selavi_tpu_torch.models.timesformer import TimeSformer

# name -> fn(midplanes_mode, generator, num_frames, crop_size) that makes
# the tower; a tower has ``arch`` and ``feature_dim`` and takes
# ``forward(video, return_map=False, generator=None, shard=(0, 1))``
VIDEO_ARCHS = {
    "r2plus1d_18": lambda mode, g, frames, crop: R2Plus1D18(mode, g),
    "timesformer_base": lambda mode, g, frames, crop: TimeSformer(
        g, num_frames=frames, img_size=crop),
}


def build_video_tower(arch: str, midplanes_mode: str,
                      generator: torch.Generator, num_frames: int = 8,
                      crop_size: int = 224):
    """The video tower ``arch`` drawn from ``generator``; TimeSformer's
    ``time_embed`` and ``pos_embed`` are sized for ``num_frames`` frames of
    ``crop_size`` px."""
    if arch not in VIDEO_ARCHS:
        raise ValueError(f"unsupported video arch: {arch!r} (have "
                         f"{sorted(VIDEO_ARCHS)})")
    return VIDEO_ARCHS[arch](midplanes_mode, generator, num_frames,
                             crop_size)


class AVModel(nn.Module):
    def __init__(self, vid_base_arch: str = "r2plus1d_18",
                 aud_base_arch: str = "resnet9", use_mlp: bool = True,
                 headcount: int = 1, num_classes: int = 256,
                 midplanes_mode: str = "parity",
                 generator: Optional[torch.Generator] = None,
                 audio_channels: int = 1, grid=None, num_frames: int = 8,
                 crop_size: int = 224):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.grid = grid
        heads = {} if grid is None else {"owned": grid.heads(headcount),
                                         "bn_group": grid.data_group}
        self.video_network = build_video_tower(vid_base_arch, midplanes_mode,
                                               g, num_frames, crop_size)
        self.audio_network = AudioResNet(aud_base_arch, g, audio_channels)
        self.heads_v = HeadStack(headcount, self.video_network.feature_dim,
                                 num_classes, use_mlp=use_mlp, generator=g,
                                 **heads)
        self.heads_a = HeadStack(headcount, AUDIO_ARCHS[aud_base_arch][2],
                                 num_classes, use_mlp=use_mlp, generator=g,
                                 **heads)

    def forward(self, video, audio, return_features: bool = False,
                generator: Optional[torch.Generator] = None,
                shard: tuple[int, int] = (0, 1)):
        """``shard = (rank, world)``: dropout masks drawn for the global
        batch, of which this rank keeps its rows (``heads.head_dropout``)."""
        feats = self.towers(video, audio, generator, shard)
        if return_features:
            return feats
        return self.heads(*feats, generator=generator, shard=shard)

    def towers(self, video, audio, generator=None, shard=(0, 1)):
        """Pooled features ``(feat_v, feat_a)`` of this rank's rows; a
        train-mode video tower's drop-path draws from ``generator``."""
        return (self.video_network(video, generator=generator, shard=shard),
                self.audio_network(audio))

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
        """The video tower's map before pooling, ``[B, t, h, w, D_v]`` in
        fp32: R(2+1)D's pre-GAP map, TimeSformer's final-normed patch
        tokens."""
        return self.video_network(video, return_map=True)

    def video_heads(self, feat_v, generator=None, shard=(0, 1)):
        """The owned video heads on pooled features [B, D_v] -> [H, B, K]
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
               grid=None, num_frames: int = 8, crop_size: int = 224,
               **_unused) -> AVModel:
    """Build an AVModel with weights drawn from ``seed`` and move it to
    ``device`` (the card unless ``device="cpu"`` is given). Its audio stem
    takes ``audio_channels`` spectrograms (2 for dual_data). On a ``grid``
    it holds this rank's slice of the heads. ``num_frames`` and
    ``crop_size`` size TimeSformer's embeddings (R(2+1)D takes any)."""
    from selavi_tpu_torch.device import resolve_device

    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = AVModel(vid_base_arch, aud_base_arch, use_mlp, headcount,
                    num_classes, midplanes_mode, generator=g,
                    audio_channels=audio_channels, grid=grid,
                    num_frames=num_frames, crop_size=crop_size)
    return model.to(device)
