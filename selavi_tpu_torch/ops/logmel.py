"""Batched log filterbank spectrograms on the card
(``selavi_tpu/ops/logmel.py``).

The reference computes spectrograms per sample on the host inside its
DataLoader workers (python_speech_features ``logfbank``, audio_utils.py:
46-63). With ``--device_spectrogram`` the host ships raw PCM clips
``[B, S]`` and the card computes every spectrogram of the batch:

* preemphasis 0.97, zero pad, framing = one strided view
  ``[B, F, frame_len]`` (``unfold``: the gather of the JAX package's
  version, with no copy);
* power spectrum = ``torch.fft.rfft(n=1024)`` (cuFFT on the card),
  ``|X|^2 / nfft``;
* mel projection = one fp32 matmul against the triangular filterbank of
  ``data/audio.py::mel_filterbank``, cached per (nfilt, samplerate,
  device);
* log floored at float64 eps, as the host frontends floor zero energies.

The JAX package computes this in XLA with no Pallas kernel, so the port
runs the same steps as library calls. Numerically matched to the host
``data/audio.py::logfbank`` (fp32 here, float64 there).
"""

from __future__ import annotations

import functools

import torch

from selavi_tpu_torch.data.audio import (
    _round_half_up,
    frame_count,
    mel_filterbank,
)

# np.finfo(np.float64).eps: the host frontends replace zero energies with
# it before the log (log = -36.04); fp32 tiny would give -87.3.
LOG_FLOOR = 2.220446049250313e-16


@functools.lru_cache(maxsize=16)
def _filterbank_t(nfilt: int, nfft: int, samplerate: int,
                  device: torch.device) -> torch.Tensor:
    """fp32 ``[nfft//2 + 1, nfilt]`` on ``device``, made once."""
    fb = mel_filterbank(nfilt, nfft, samplerate)
    return torch.tensor(fb.T, dtype=torch.float32, device=device)


def logfbank_batch(pcm: torch.Tensor, samplerate: int = 48000,
                   nfilt: int = 257, nfft: int = 1024, winlen: float = 0.02,
                   winstep: float = 0.01, preemph: float = 0.97,
                   z_normalize: bool = False) -> torch.Tensor:
    """PCM ``[B, S]`` (int16-scale values, any real dtype) -> fp32
    spectrograms ``[B, nfilt, F]``, per sample the ``[1, nfilt, T]`` of
    ``data/audio.py::get_spec`` (reference audio_utils.py:66-72). Runs in
    fp32 under any autocast."""
    with torch.autocast(pcm.device.type, enabled=False):
        return _logfbank(pcm.float(), samplerate, nfilt, nfft, winlen,
                         winstep, preemph, z_normalize)


def _logfbank(pcm, samplerate, nfilt, nfft, winlen, winstep, preemph,
              z_normalize):
    slen = pcm.shape[1]
    frame_len = _round_half_up(winlen * samplerate)
    frame_step = _round_half_up(winstep * samplerate)
    nframes = frame_count(slen, frame_len, frame_step)

    pcm = torch.cat([pcm[:, :1], pcm[:, 1:] - preemph * pcm[:, :-1]], dim=1)
    padlen = (nframes - 1) * frame_step + frame_len
    pcm = torch.nn.functional.pad(pcm, (0, max(padlen - slen, 0)))
    frames = pcm.unfold(1, frame_len, frame_step)  # [B, F, frame_len]

    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    pspec = (spec.real ** 2 + spec.imag ** 2) / nfft
    feat = pspec @ _filterbank_t(nfilt, nfft, samplerate, pcm.device)
    out = torch.log(torch.clamp_min(feat, LOG_FLOOR)).transpose(1, 2)
    if z_normalize:
        out = (out - 1.93) / 17.89
    return out
