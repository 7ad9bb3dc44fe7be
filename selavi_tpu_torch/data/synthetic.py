"""Synthetic audio-visual dataset: correlated modalities, known clusters.

The port's copy of ``selavi_tpu/data/synthetic.py``. Audio is a
spectrogram, or with ``return_pcm`` the raw clip waveform for the card's
frontend; with ``dual_data`` (train mode) every sample carries two clips,
concatenated along time, and two audio clips (channel-stacked
spectrograms ``[F, T, 2]`` or PCM ``[2, S]``). A synthetic in-memory AV
dataset (random frames + sine-wave audio) smokes the full training loop
without media files or decode libraries. Each sample's class drives both a
visual signature (colored moving square on textured background) and an
audio signature (class-specific sine frequency), so self-labeling has real
cross-modal structure to discover.

Deterministic per (index, clip draw): content depends only on the index and
the RNG handed in, so eval re-reads are reproducible.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from selavi_tpu_torch.data.audio import get_spec, spec_num_frames


class SyntheticAVDataset:
    """Map-style dataset yielding the same tuple contract as the reference's
    ``AVideoDataset.__getitem__`` (reference datasets/AVideoDataset.py:
    355-454): ``(frames, spec, label, index, vid_idx)``."""

    def __init__(
        self,
        num_samples: int = 64,
        num_classes: int = 8,
        num_frames: int = 8,
        crop_size: int = 64,
        num_sec: int = 1,
        aud_sample_rate: int = 24000,
        aud_spec_type: int = 1,
        z_normalize: bool = False,
        seed: int = 0,
        mode: str = "train",
        return_pcm: bool = False,
        dual_data: bool = False,
    ):
        self.dual_data = dual_data
        self.num_samples = num_samples
        self.num_classes = num_classes
        self.num_frames = num_frames
        self.crop_size = crop_size
        self.num_sec = num_sec
        self.aud_sample_rate = aud_sample_rate
        self.aud_spec_type = aud_spec_type
        self.z_normalize = z_normalize
        self.mode = mode
        self.return_pcm = return_pcm
        self.name = "synthetic"
        # Signature v2 for high class counts: the v1 audio map
        # f0 = 110*2^(label/2) passes Nyquist at label ~= 2*log2(sr/220)
        # (label 14 at 24 kHz), after which classes alias onto each other,
        # and v1 orbit speed 1+label aliases against num_frames. v2 keeps
        # every class signature distinct at any K: log-spaced fundamentals
        # inside [110, 0.35*sr], golden-ratio hue scrambling, bounded
        # orbit speed, and a static class-position marker square. v1 is
        # bit-preserved for <=12 classes (every quality record in
        # BASELINE.md up to r2 used <=8 true classes).
        self._sig_v2 = num_classes > 12
        base = np.random.default_rng(seed)
        self._labels = base.integers(
            0, num_classes, size=num_samples
        ).astype(np.int64)
        # per-sample appearance variation
        self._phase = base.uniform(0, 2 * np.pi, size=num_samples)
        self.valid_indices = np.arange(num_samples)

    def __len__(self):
        return self.num_samples

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    def spec_shape(self):
        nfilt = 40 if self.aud_spec_type == 1 else 257
        return (nfilt, spec_num_frames(self.num_sec, self.aud_sample_rate))

    def get_example(
        self, idx: int, rng: Optional[np.random.Generator] = None
    ) -> dict:
        if rng is None:
            rng = np.random.default_rng(idx)
        label = int(self._labels[idx])
        c = self.crop_size
        t = self.num_frames

        # --- video: class-colored square orbiting at class-dependent speed
        if self._sig_v2:
            # golden-ratio scrambling: adjacent labels land far apart on
            # the hue circle even at K=309
            hue = (label * 0.61803398875) % 1.0
        else:
            hue = label / self.num_classes
        color = np.array(
            [
                0.5 + 0.5 * np.sin(2 * np.pi * hue),
                0.5 + 0.5 * np.sin(2 * np.pi * hue + 2.1),
                0.5 + 0.5 * np.sin(2 * np.pi * hue + 4.2),
            ]
        )
        num_clips = 2 if self.dual_data and self.mode == "train" else 1

        def one_clip(phase):
            # uint8 noise background directly (float64 uniform draws
            # dominated per-sample cost at paper-scale shapes)
            clip = rng.integers(0, 39, size=(t, c, c, 3), dtype=np.uint8)
            color_u8 = (color * 255).astype(np.uint8)
            radius = c // 4
            sq = max(c // 8, 2)
            if self._sig_v2:
                # bounded speed (v1's 1+label aliases against t frames);
                # orbit direction and a STATIC class-position marker
                # square (4x4 grid cell = label % 16) carry the rest of
                # the class identity
                speed = 1.0 + (label % 12)
                direction = 1.0 if (label // 12) % 2 == 0 else -1.0
                gx, gy = label % 4, (label // 4) % 4
                my = int((gy + 0.5) * c / 4)
                mx = int((gx + 0.5) * c / 4)
                msq = max(c // 16, 2)
                clip[
                    :,
                    max(my - msq, 0) : min(my + msq, c),
                    max(mx - msq, 0) : min(mx + msq, c),
                    :,
                ] = color_u8
            else:
                speed = 1.0 + label
                direction = 1.0
            for f in range(t):
                ang = phase + direction * speed * f / t * 2 * np.pi
                cy = int(c / 2 + radius * np.sin(ang))
                cx = int(c / 2 + radius * np.cos(ang))
                y0, y1 = max(cy - sq, 0), min(cy + sq, c)
                x0, x1 = max(cx - sq, 0), min(cx + sq, c)
                clip[f, y0:y1, x0:x1, :] = color_u8
            return clip

        # dual_data: two independently sampled clips of the same "video",
        # concatenated along time (reference AVideoDataset.py:431-451).
        # Clip 0 draws no extra RNG so the non-dual stream (and the
        # seed-keyed quality records in BASELINE.md) stays bit-identical.
        video = np.concatenate(
            [
                one_clip(
                    self._phase[idx]
                    if k == 0
                    else self._phase[idx] + rng.uniform(0, 2 * np.pi)
                )
                for k in range(num_clips)
            ],
            axis=0,
        )

        # --- audio: class-frequency sine + harmonics, int16 scale
        sr = self.aud_sample_rate
        dur = self.num_sec + 1  # file longer than the clip, like real videos
        if self._sig_v2:
            # log-spaced fundamentals spanning [110, 0.35*sr]: distinct
            # and alias-free for any class count (v1's 2^(label/2) passes
            # Nyquist at label ~14 @ 24 kHz)
            top = 0.35 * sr
            f0 = 110.0 * (top / 110.0) ** (
                label / max(self.num_classes - 1, 1)
            )
            # drop the octave harmonic once it would fold over Nyquist
            # (an aliased harmonic could land on another class's band)
            h_amp = 0.3 if 2 * f0 < 0.45 * sr else 0.0
        else:
            f0 = 110.0 * (2.0 ** (label / 2.0))
            h_amp = 0.3

        out = {
            "video": video,  # [T*num_clips, H, W, 3] uint8
            "label": label,
            "index": idx,
            "vid_idx": idx,
        }
        def synth(start_sample: int, length: int) -> np.ndarray:
            """Sample the class waveform on [start, start+length) only —
            sine phases are absolute in time, so windowed synthesis is
            identical math at a fraction of the cost (the v1 path keeps
            full-duration synthesis for bit-compat with <=12-class
            records)."""
            tt = (
                np.arange(start_sample, start_sample + length) / sr
            ).astype(np.float32)
            w = 0.6 * np.sin(
                2 * np.pi * f0 * tt + self._phase[idx], dtype=np.float32
            ) + h_amp * np.sin(2 * np.pi * 2 * f0 * tt, dtype=np.float32)
            w += 0.05 * rng.standard_normal(length).astype(np.float32)
            return w * 8000.0

        if self._sig_v2:
            fr_secs = [
                rng.uniform(0, dur - self.num_sec)
                for _ in range(num_clips)
            ]
            clips = [
                synth(int(np.round(fs * sr)), self.num_sec * sr)
                for fs in fr_secs
            ]
            if self.return_pcm:
                out["audio_pcm"] = (
                    clips[0].astype(np.float32)
                    if num_clips == 1
                    else np.stack(clips).astype(np.float32)
                )
            else:
                specs = [
                    get_spec(
                        c,
                        0.0,
                        num_sec=self.num_sec,
                        sample_rate=sr,
                        aud_spec_type=self.aud_spec_type,
                        z_normalize=self.z_normalize,
                        rng=rng,
                    )[0].astype(np.float32)
                    for c in clips
                ]
                out["audio"] = (
                    specs[0] if num_clips == 1 else np.stack(specs, axis=-1)
                )
            return out

        # v1: full-duration float64 synthesis with fr_secs drawn AFTER the
        # noise — the RNG consumption order the <=12-class records pinned
        tt = np.arange(dur * sr) / sr
        wav = (
            0.6 * np.sin(2 * np.pi * f0 * tt + self._phase[idx])
            + h_amp * np.sin(2 * np.pi * 2 * f0 * tt)
            + 0.05 * rng.standard_normal(len(tt))
        )
        wav = (wav * 8000).astype(np.float64)
        fr_secs = [
            rng.uniform(0, dur - self.num_sec) for _ in range(num_clips)
        ]
        if self.return_pcm:
            # device-spectrogram path: ship the raw clip waveform; the
            # fused on-device kernel (ops/logmel.py) computes the spec.
            # dual_data: [2, S] — clip rows become spectrogram channels.
            pcm = []
            for fr_sec in fr_secs:
                fr = int(np.round(fr_sec * sr))
                pcm.append(
                    wav[fr : fr + self.num_sec * sr].astype(np.float32)
                )
            out["audio_pcm"] = pcm[0] if num_clips == 1 else np.stack(pcm)
        else:
            specs = [
                get_spec(
                    wav,
                    fr_sec,
                    num_sec=self.num_sec,
                    sample_rate=sr,
                    aud_spec_type=self.aud_spec_type,
                    z_normalize=self.z_normalize,
                    rng=rng,
                )[0].astype(np.float32)  # [nfilt, T]
                for fr_sec in fr_secs
            ]
            # dual_data: channel-stacked [F, T, 2] (AVideoDataset.py:451)
            out["audio"] = (
                specs[0] if num_clips == 1 else np.stack(specs, axis=-1)
            )
        return out
