"""Move weights between the JAX package's flax variables and the port's
AVModel.

``load_jax_variables(model, params, batch_stats)`` takes the flax trees as
nested dicts of numpy arrays and fills the module strictly: every flax leaf
must be used and every parameter and buffer of the module must be filled,
with matching shapes, or it raises before anything is copied
(``load_jax_finetune_variables`` does the same for the finetune model).
Then both frameworks compute the same function.
``export_jax_variables(model)`` is its exact inverse: the same walk,
giving ``(params, batch_stats)`` as numpy trees in the flax layout.
Layout transforms (the key walk follows
``selavi_tpu/train/torch_export.py``):

* conv kernels ``[*k, I, O] -> [O, I, *k]``;
* head-stack Dense kernels stay ``[H, I, O]`` (the port's stacked layout);
* BatchNorm ``scale/bias`` -> ``weight/bias`` and batch stats
  ``mean/var`` -> ``running_mean/running_var``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from selavi_tpu_torch.models.resnet_audio import Bottleneck2D


def _leaf_paths(tree, prefix=()) -> Iterator[Tuple[str, ...]]:
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaf_paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


class _Walker:
    """Pairs each port key with its flax leaf; ``leaf`` moves the value one
    way or the other."""

    def conv(self, tkey: str, *path):
        self.leaf(tkey, "params", *path, "kernel", conv=True)

    def bn(self, tprefix: str, *path):
        self.leaf(f"{tprefix}.weight", "params", *path, "scale")
        self.leaf(f"{tprefix}.bias", "params", *path, "bias")
        self.leaf(f"{tprefix}.running_mean", "batch_stats", *path, "mean")
        self.leaf(f"{tprefix}.running_var", "batch_stats", *path, "var")


class _Reader(_Walker):
    """flax -> port: reads flax leaves by path and remembers which were
    read."""

    def __init__(self, params: dict, batch_stats: dict):
        self.trees = {"params": params, "batch_stats": batch_stats}
        self.used = set()
        self.out: Dict[str, np.ndarray] = {}

    def leaf(self, tkey: str, collection: str, *path, conv: bool = False):
        node = self.trees[collection]
        for key in path:
            if key not in node:
                raise KeyError(
                    f"flax {collection} has no {'/'.join(path)}"
                )
            node = node[key]
        self.used.add((collection,) + tuple(path))
        value = np.asarray(node, np.float32)
        if conv:  # [*k, I, O] -> [O, I, *k]
            nd = value.ndim
            value = np.transpose(value, (nd - 1, nd - 2) + tuple(range(nd - 2)))
        self.out[tkey] = value

    def unused(self):
        every = {("params",) + p for p in _leaf_paths(self.trees["params"])}
        every |= {("batch_stats",) + p
                  for p in _leaf_paths(self.trees["batch_stats"])}
        return sorted("/".join(p) for p in every - self.used)


class _Writer(_Walker):
    """port -> flax: builds the flax trees from the module's state."""

    def __init__(self, state: Dict[str, torch.Tensor]):
        self.state = state
        self.trees = {"params": {}, "batch_stats": {}}
        self.used = set()

    def leaf(self, tkey: str, collection: str, *path, conv: bool = False):
        value = self.state[tkey].detach().to("cpu", torch.float32,
                                             copy=True).numpy()
        if conv:  # [O, I, *k] -> [*k, I, O]
            value = np.ascontiguousarray(np.transpose(
                value, tuple(range(2, value.ndim)) + (1, 0)))
        node = self.trees[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
        self.used.add(tkey)


def _walk_video(w: _Walker, has_downsample, tprefix: str = "video_network",
                fpath: str = "video_network") -> None:
    """The R(2+1)D tower under port module ``tprefix`` and flax path
    ``fpath`` (``base`` in the finetune model)."""
    v = fpath
    w.conv(f"{tprefix}.stem_spatial.weight", v, "stem_spatial", "conv")
    w.bn(f"{tprefix}.stem_bn1", v, "stem_bn1", "bn")
    w.conv(f"{tprefix}.stem_temporal.weight", v, "stem_temporal", "conv")
    w.bn(f"{tprefix}.stem_bn2", v, "stem_bn2", "bn")
    for stage in range(1, 5):
        for block in range(2):
            name = f"layer{stage}_block{block}"
            t = f"{tprefix}.{name}"
            for ci in ("conv1", "conv2"):
                w.conv(f"{t}.{ci}.spatial.weight", v, name, ci, "spatial",
                       "conv")
                w.bn(f"{t}.{ci}.bn_mid", v, name, ci, "bn_mid", "bn")
                w.conv(f"{t}.{ci}.temporal.weight", v, name, ci, "temporal",
                       "conv")
            w.bn(f"{t}.bn1", v, name, "bn1", "bn")
            w.bn(f"{t}.bn2", v, name, "bn2", "bn")
            if has_downsample(f"{t}.downsample.conv.weight"):
                w.conv(f"{t}.downsample.conv.weight", v, name, "downsample",
                       "conv")
                w.bn(f"{t}.downsample.bn", v, name, "downsample", "bn", "bn")


def _walk_audio(w: _Walker, n_blocks: int, bottleneck: bool,
                has_downsample) -> None:
    """flax names a block's ConvBNs in call order: conv1, conv2 (, conv3
    for a Bottleneck), then the projection."""
    a = "audio_network"
    block_cls = "Bottleneck2D" if bottleneck else "BasicBlock2D"
    convs = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")

    def convbn(tprefix, *path):
        w.conv(f"{tprefix}.conv.weight", *path, "Conv_0")
        w.bn(f"{tprefix}.bn", *path, "BatchNorm_0")

    convbn(f"{a}.stem", a, "ConvBN_0")
    for i in range(n_blocks):
        t = f"{a}.blocks.{i}"
        block = f"{block_cls}_{i}"
        for j, name in enumerate(convs):
            convbn(f"{t}.{name}", a, block, f"ConvBN_{j}")
        if has_downsample(f"{t}.downsample.conv.weight"):
            convbn(f"{t}.downsample", a, block, f"ConvBN_{len(convs)}")


def _walk_heads(w: _Walker, name: str, use_mlp: bool) -> None:
    if use_mlp:
        w.leaf(f"{name}.hidden_weight", "params", name, "heads", "hidden",
               "kernel")
        w.leaf(f"{name}.bn_weight", "params", name, "heads", "bn", "scale")
        w.leaf(f"{name}.bn_bias", "params", name, "heads", "bn", "bias")
        w.leaf(f"{name}.bn_running_mean", "batch_stats", name, "heads", "bn",
               "mean")
        w.leaf(f"{name}.bn_running_var", "batch_stats", name, "heads", "bn",
               "var")
    w.leaf(f"{name}.proj_weight", "params", name, "heads", "proj", "kernel")
    w.leaf(f"{name}.proj_bias", "params", name, "heads", "proj", "bias")


def _walk(w: _Walker, model, state) -> None:
    _walk_video(w, lambda key: key in state)
    _walk_audio(w, len(model.audio_network.blocks),
                isinstance(model.audio_network.blocks[0], Bottleneck2D),
                lambda key: key in state)
    _walk_heads(w, "heads_v", model.heads_v.use_mlp)
    _walk_heads(w, "heads_a", model.heads_a.use_mlp)


def jax_audio_channels(params: dict) -> int:
    """The input channels of the audio stem in flax ``params`` (1, or 2
    for a dual_data run): the ``audio_channels`` of the AVModel that
    ``load_jax_variables`` can fill from them."""
    kernel = params["audio_network"]["ConvBN_0"]["Conv_0"]["kernel"]
    return int(np.shape(kernel)[-2])  # [kh, kw, I, O]


def _walk_finetune(w: _Walker, model, state) -> None:
    """``FinetuneModel``: flax ``base`` (the tower), ``final_bn`` (flax
    BatchNorm: scale/bias, mean/var) and ``classifier`` (Dense kernel
    ``[I, O]`` -> Linear weight ``[O, I]``)."""
    _walk_video(w, lambda key: key in state, "base", "base")
    if model.final_bn is not None:
        w.bn("final_bn", "final_bn")
    w.conv("classifier.weight", "classifier")
    w.leaf("classifier.bias", "params", "classifier", "bias")


def load_jax_variables(model, params: dict, batch_stats: dict) -> None:
    """Fill ``model`` (an ``AVModel``) from flax ``params``/``batch_stats``
    trees of numpy arrays. Raises on a missing or extra key or a shape
    mismatch on either side."""
    _load(model, _walk, params, batch_stats)


def load_jax_finetune_variables(model, params: dict,
                                batch_stats: dict) -> None:
    """``load_jax_variables`` for a ``FinetuneModel`` from JAX's
    ``{"base", "final_bn", "classifier"}`` trees."""
    _load(model, _walk_finetune, params, batch_stats)


def _load(model, walk, params: dict, batch_stats: dict) -> None:
    state = model.state_dict()
    w = _Reader(params, batch_stats or {})
    walk(w, model, state)
    extra = w.unused()
    if extra:
        raise KeyError(f"flax leaves with no place in the model: {extra}")
    missing = sorted(set(state) - set(w.out))
    unexpected = sorted(set(w.out) - set(state))
    if missing or unexpected:
        raise KeyError(f"missing {missing}, unexpected {unexpected}")
    shapes = [f"{key}: model {tuple(state[key].shape)} vs flax {value.shape}"
              for key, value in w.out.items()
              if tuple(state[key].shape) != value.shape]
    if shapes:
        raise ValueError(f"shapes differ: {shapes}")
    with torch.no_grad():
        for key, value in w.out.items():
            state[key].copy_(torch.tensor(value))


def export_jax_variables(model) -> Tuple[dict, dict]:
    """``(params, batch_stats)`` of ``model`` (an ``AVModel``) as nested
    dicts of float32 numpy arrays in the flax layout, copied off the
    module: the inverse of ``load_jax_variables``."""
    state = model.state_dict()
    w = _Writer(state)
    _walk(w, model, state)
    unused = sorted(set(state) - w.used)
    if unused:
        raise KeyError(f"model keys with no place in the flax trees: {unused}")
    return w.trees["params"], w.trees["batch_stats"]
