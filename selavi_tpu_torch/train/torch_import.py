"""Import reference-layout PyTorch checkpoints into the port's AVModel: the
inverse of ``train/torch_export.py`` (the port's counterpart of
``selavi_tpu/train/torch_import.py``).

A reference ``checkpoint.pth.tar`` (the reference's own releases, or a JAX
or port run exported by ``export_torch.py`` / ``train/torch_export.py``)
holds a ``model`` entry: a state_dict over torchvision modules, DDP-prefixed
with ``module.``. Its keys map onto the port's:

* video tower, torchvision ``VideoResNet`` -> ``models/r2plus1d.py``:
  ``stem.{0,1,3,4}``, ``layer{s}.{b}.conv{i}.0.{0,1,3}`` (spatial conv,
  midplane BN, temporal conv), ``conv{1,2}.1`` (the block BNs) and
  ``downsample.{0,1}``; the same ``[O, I, *k]`` kernels;
* audio tower, torchvision ``ResNet`` -> ``models/resnet_audio.py``:
  ``conv1/bn1`` (the stem) and ``layer{s}.{b}.conv{j}/bn{j}`` with
  ``downsample.{0,1}``, BasicBlocks (resnet9/18/34) or Bottlenecks
  (resnet50, with ``layer1.0.conv3``), the port's blocks numbered across
  stages;
* heads: per-name ``mlp_{v,a}{i}.block_forward.{2,4,8}`` MLPv2 modules
  (bare ``mlp_v``/``mlp_a`` at headcount 1; ``mlp_{v,a}{i}.{weight,bias}``
  for linear heads) stack into the port's ``[H, ...]`` head parameters,
  the Linear weights ``[O, I]`` transposed to ``[I, O]``.

BatchNorm's ``num_batches_tracked`` has no place in the port and is
dropped. The import is strict: every tensor of the file must find its place
and every parameter and buffer of the model must be filled at its shape, or
it raises before any tensor is copied.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS

logger = logging.getLogger(__name__)

VIDEO_PREFIX = "video_network.base."
AUDIO_PREFIX = "audio_network.base."
BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def read_reference_state_dict(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The ``model`` state_dict of a reference-layout file with the DDP
    ``module.`` prefix stripped, or None when ``path`` holds no such
    state_dict (a port checkpoint, whose keys are the port's). The file is
    mapped, not read, until a tensor is used."""
    blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    state = blob["model"] if isinstance(blob, dict) and "model" in blob \
        else blob
    if not isinstance(state, dict):
        return None
    state = {k.replace("module.", ""): v for k, v in state.items()}
    if not any(k.startswith(VIDEO_PREFIX) for k in state):
        return None
    return state


def _bn(pairs: dict, port: str, ref: str) -> None:
    for field in BN_FIELDS:
        pairs[f"{port}.{field}"] = f"{ref}.{field}"


def _video_pairs(model) -> dict:
    """Port key -> reference key for the video tower."""
    pairs = {}
    v, r = "video_network", VIDEO_PREFIX
    pairs[f"{v}.stem_spatial.weight"] = f"{r}stem.0.weight"
    _bn(pairs, f"{v}.stem_bn1", f"{r}stem.1")
    pairs[f"{v}.stem_temporal.weight"] = f"{r}stem.3.weight"
    _bn(pairs, f"{v}.stem_bn2", f"{r}stem.4")
    for stage in range(1, 5):
        for block in range(2):
            t = f"{v}.layer{stage}_block{block}"
            tr = f"{r}layer{stage}.{block}"
            for ci in ("conv1", "conv2"):
                pairs[f"{t}.{ci}.spatial.weight"] = f"{tr}.{ci}.0.0.weight"
                _bn(pairs, f"{t}.{ci}.bn_mid", f"{tr}.{ci}.0.1")
                pairs[f"{t}.{ci}.temporal.weight"] = f"{tr}.{ci}.0.3.weight"
            # torchvision keeps the block BNs inside the conv Sequentials
            _bn(pairs, f"{t}.bn1", f"{tr}.conv1.1")
            _bn(pairs, f"{t}.bn2", f"{tr}.conv2.1")
            if getattr(model.video_network,
                       f"layer{stage}_block{block}").downsample is not None:
                pairs[f"{t}.downsample.conv.weight"] = (
                    f"{tr}.downsample.0.weight")
                _bn(pairs, f"{t}.downsample.bn", f"{tr}.downsample.1")
    return pairs


def _audio_pairs(model) -> dict:
    """Port key -> reference key for the audio tower."""
    audio = model.audio_network
    kind, stage_blocks, _ = AUDIO_ARCHS[audio.arch]
    convs = (1, 2, 3) if kind == "bottleneck" else (1, 2)
    pairs = {}
    a, r = "audio_network", AUDIO_PREFIX
    pairs[f"{a}.stem.conv.weight"] = f"{r}conv1.weight"
    _bn(pairs, f"{a}.stem.bn", f"{r}bn1")
    i = 0
    for stage, nblocks in enumerate(stage_blocks, 1):
        for b in range(nblocks):
            t, tr = f"{a}.blocks.{i}", f"{r}layer{stage}.{b}"
            for j in convs:
                pairs[f"{t}.conv{j}.conv.weight"] = f"{tr}.conv{j}.weight"
                _bn(pairs, f"{t}.conv{j}.bn", f"{tr}.bn{j}")
            if audio.blocks[i].downsample is not None:
                pairs[f"{t}.downsample.conv.weight"] = (
                    f"{tr}.downsample.0.weight")
                _bn(pairs, f"{t}.downsample.bn", f"{tr}.downsample.1")
            i += 1
    return pairs


def _head_parts(heads, tag: str) -> dict:
    """Port head key -> per-head reference keys and whether each is a
    Linear weight (transposed)."""
    h = heads.headcount
    names = [f"mlp_{tag}." if h == 1 else f"mlp_{tag}{i}." for i in range(h)]
    if not heads.use_mlp:
        return {"proj_weight": ([n + "weight" for n in names], True),
                "proj_bias": ([n + "bias" for n in names], False)}
    bf = [n + "block_forward." for n in names]
    return {
        "hidden_weight": ([p + "2.weight" for p in bf], True),
        "bn_weight": ([p + "4.weight" for p in bf], False),
        "bn_bias": ([p + "4.bias" for p in bf], False),
        "bn_running_mean": ([p + "4.running_mean" for p in bf], False),
        "bn_running_var": ([p + "4.running_var" for p in bf], False),
        "proj_weight": ([p + "8.weight" for p in bf], True),
        "proj_bias": ([p + "8.bias" for p in bf], False),
    }


def port_state_from_reference(model, ref: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` of ``model``'s architecture built from a
    reference state_dict; raises ``ValueError`` naming what does not fit
    (a key either side lacks, or a shape)."""
    target = model.state_dict()
    pairs = {**_video_pairs(model), **_audio_pairs(model)}
    out: Dict[str, torch.Tensor] = {}
    used, missing = set(), []
    for port_key, ref_key in pairs.items():
        if ref_key in ref:
            out[port_key] = ref[ref_key]
            used.add(ref_key)
        else:
            missing.append(ref_key)
    for name, tag in (("heads_v", "v"), ("heads_a", "a")):
        for field, (keys, linear) in _head_parts(getattr(model, name),
                                                 tag).items():
            absent = [k for k in keys if k not in ref]
            if absent:
                missing += absent
                continue
            parts = [ref[k].t() if linear else ref[k] for k in keys]
            out[f"{name}.{field}"] = torch.stack(parts)
            used.update(keys)
    unused = sorted(k for k in set(ref) - used
                    if not k.endswith("num_batches_tracked"))
    unfilled = sorted(set(target) - set(out))
    shapes = sorted(
        f"{k}: model {tuple(target[k].shape)} vs file {tuple(v.shape)}"
        for k, v in out.items()
        if k in target and tuple(target[k].shape) != tuple(v.shape))
    if missing or unused or unfilled or shapes:
        raise ValueError(
            "the reference checkpoint does not fit the model (--headcount, "
            "--use_mlp, --aud_base_arch, --mlp_dim, "
            f"--tpu_aligned_midplanes?): missing {missing[:5]}, with no "
            f"place {unused[:5]}, unfilled {unfilled[:5]}, shapes "
            f"{shapes[:5]}")
    return out


def import_reference_checkpoint(model, path: str):
    """Fill ``model`` (an ``AVModel``) from the reference-layout file at
    ``path``, strictly; nothing is copied unless everything fits."""
    ref = read_reference_state_dict(path)
    if ref is None:
        raise ValueError(f"{path} holds no reference-layout state_dict")
    state = port_state_from_reference(model, ref)
    model.load_state_dict(state)
    logger.info("imported reference checkpoint %s (headcount %d, use_mlp "
                "%s, audio %s)", path, model.heads_v.headcount,
                model.heads_v.use_mlp, model.audio_network.arch)
    return model
