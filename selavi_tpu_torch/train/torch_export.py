"""Export a port checkpoint to the reference PyTorch layout
(``selavi_tpu/train/torch_export.py``).

    python -m selavi_tpu_torch.train.torch_export checkpoint.pth out.pth.tar

writes a ``checkpoint.pth.tar``-style file whose ``model`` entry is a
DDP-prefixed state_dict in the reference's torchvision naming, beside
``epoch``, ``dist`` and ``selflabels`` (no optimizer: the reference's eval
tools read only ``model``). The JAX package's ``train/torch_import.py`` and
the reference's own tools read it. The route is the port's
``models/convert.py::export_jax_variables`` (port module -> flax trees),
then the port's copy of the JAX exporter's walkers (flax trees ->
torchvision keys):

* conv kernels ``[*k, I, O] -> [O, I, *k]``; Linear ``[I, O] -> [O, I]``;
* BatchNorm {scale,bias} -> {weight,bias}, batch_stats {mean,var} ->
  {running_mean,running_var}, and a zero ``num_batches_tracked``;
* the head stacks ``[H, ...]`` unstack to per-name
  ``mlp_{v,a}{i}.block_forward.{2,4,8}`` modules.

Only reference-parity towers load into torchvision's r2plus1d_18: a tower
trained with ``--tpu_aligned_midplanes`` is exported with a warning. The
file is read with ``map_location="cpu"``; nothing runs on the card.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import export_jax_variables
from selavi_tpu_torch.models.r2plus1d import _midplanes
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS

logger = logging.getLogger(__name__)

# (audio blocks in the port's state_dict, Bottleneck blocks) -> arch
_AUDIO_BY_BLOCKS = {(4, False): "resnet9", (8, False): "resnet18",
                    (16, False): "resnet34", (16, True): "resnet50"}


def _conv_out(kernel) -> np.ndarray:
    """[*k, I, O] -> [O, I, *k]."""
    k = np.asarray(kernel)
    nd = k.ndim
    perm = (nd - 1, nd - 2) + tuple(range(nd - 2))
    return np.ascontiguousarray(np.transpose(k, perm).astype(np.float32))


def _put_bn(sd: dict, tprefix: str, params: dict, stats: dict):
    sd[f"{tprefix}.weight"] = np.asarray(params["scale"], np.float32)
    sd[f"{tprefix}.bias"] = np.asarray(params["bias"], np.float32)
    sd[f"{tprefix}.running_mean"] = np.asarray(stats["mean"], np.float32)
    sd[f"{tprefix}.running_var"] = np.asarray(stats["var"], np.float32)
    sd[f"{tprefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_video_tower(
    params: dict, batch_stats: dict, prefix: str = "video_network.base."
) -> Dict[str, np.ndarray]:
    """R2Plus1D18 trees -> torchvision VideoResNet keys."""
    sd: Dict[str, np.ndarray] = {}
    sd[f"{prefix}stem.0.weight"] = _conv_out(
        params["stem_spatial"]["conv"]["kernel"]
    )
    _put_bn(sd, f"{prefix}stem.1", params["stem_bn1"]["bn"],
            batch_stats["stem_bn1"]["bn"])
    sd[f"{prefix}stem.3.weight"] = _conv_out(
        params["stem_temporal"]["conv"]["kernel"]
    )
    _put_bn(sd, f"{prefix}stem.4", params["stem_bn2"]["bn"],
            batch_stats["stem_bn2"]["bn"])

    for stage in range(1, 5):
        for block in range(2):
            name = f"layer{stage}_block{block}"
            t = f"{prefix}layer{stage}.{block}."
            entry, entry_bs = params[name], batch_stats[name]
            for conv_i in ("conv1", "conv2"):
                sd[t + f"{conv_i}.0.0.weight"] = _conv_out(
                    entry[conv_i]["spatial"]["conv"]["kernel"]
                )
                _put_bn(sd, t + f"{conv_i}.0.1",
                        entry[conv_i]["bn_mid"]["bn"],
                        entry_bs[conv_i]["bn_mid"]["bn"])
                sd[t + f"{conv_i}.0.3.weight"] = _conv_out(
                    entry[conv_i]["temporal"]["conv"]["kernel"]
                )
            # torchvision wraps each factorized conv in a Sequential
            # (Conv2Plus1D, BN, ReLU), so the block BNs live at conv1.1 /
            # conv2.1: there are no bare bn1/bn2 keys
            for bn_i, tname in (("bn1", "conv1.1"), ("bn2", "conv2.1")):
                _put_bn(sd, t + tname, entry[bn_i]["bn"],
                        entry_bs[bn_i]["bn"])
            if "downsample" in entry:
                sd[t + "downsample.0.weight"] = _conv_out(
                    entry["downsample"]["conv"]["kernel"]
                )
                _put_bn(sd, t + "downsample.1",
                        entry["downsample"]["bn"]["bn"],
                        entry_bs["downsample"]["bn"]["bn"])
    return sd


def export_audio_tower(
    params: dict,
    batch_stats: dict,
    prefix: str = "audio_network.base.",
    stage_blocks: Tuple[int, ...] = (1, 1, 1, 1),
) -> Dict[str, np.ndarray]:
    """AudioResNet trees -> torchvision ResNet keys: BasicBlocks
    (resnet9/18/34: conv1/bn1, conv2/bn2 [, downsample]) or Bottlenecks
    (resnet50: conv1..3/bn1..3 [, downsample]), the kind read off the
    flax block names."""
    sd: Dict[str, np.ndarray] = {}
    bottleneck = any(k.startswith("Bottleneck2D_") for k in params)
    block_cls = "Bottleneck2D" if bottleneck else "BasicBlock2D"
    pairs = [("conv1", "bn1"), ("conv2", "bn2")]
    if bottleneck:
        pairs.append(("conv3", "bn3"))

    def put_convbn(tree_p: dict, tree_bs: dict, tconv: str, tbn: str):
        sd[f"{tconv}.weight"] = _conv_out(tree_p["Conv_0"]["kernel"])
        _put_bn(sd, tbn, tree_p["BatchNorm_0"], tree_bs["BatchNorm_0"])

    put_convbn(params["ConvBN_0"], batch_stats["ConvBN_0"],
               f"{prefix}conv1", f"{prefix}bn1")
    block_idx = 0
    for stage, nblocks in enumerate(stage_blocks, 1):
        for b in range(nblocks):
            t = f"{prefix}layer{stage}.{b}."
            bname = f"{block_cls}_{block_idx}"
            inner_p, inner_bs = params[bname], batch_stats[bname]
            for j, (conv_i, bn_i) in enumerate(pairs):
                put_convbn(inner_p[f"ConvBN_{j}"], inner_bs[f"ConvBN_{j}"],
                           t + conv_i, t + bn_i)
            ds = f"ConvBN_{len(pairs)}"
            if ds in inner_p:
                put_convbn(inner_p[ds], inner_bs[ds],
                           t + "downsample.0", t + "downsample.1")
            block_idx += 1
    return sd


def export_heads(
    params: dict,
    batch_stats: dict,
    modality: str,
    headcount: int,
    use_mlp: bool = True,
) -> Dict[str, np.ndarray]:
    """Stacked head params [H, ...] -> per-name mlp_{v,a}{i} modules: MLPv2
    Sequential indices 2 = hidden Linear (no bias), 4 = BatchNorm1d, 8 =
    final Linear; headcount 1 drops the index suffix."""
    tag = "v" if modality == "v" else "a"
    heads = params["heads"]
    sd: Dict[str, np.ndarray] = {}
    for i in range(headcount):
        hp = f"mlp_{tag}{i}." if headcount > 1 else f"mlp_{tag}."
        if use_mlp:
            sd[f"{hp}block_forward.2.weight"] = np.ascontiguousarray(
                np.asarray(heads["hidden"]["kernel"][i], np.float32).T
            )
            sd[f"{hp}block_forward.4.weight"] = np.asarray(
                heads["bn"]["scale"][i], np.float32
            )
            sd[f"{hp}block_forward.4.bias"] = np.asarray(
                heads["bn"]["bias"][i], np.float32
            )
            bn_stats = batch_stats["heads"]["bn"]
            sd[f"{hp}block_forward.4.running_mean"] = np.asarray(
                bn_stats["mean"][i], np.float32
            )
            sd[f"{hp}block_forward.4.running_var"] = np.asarray(
                bn_stats["var"][i], np.float32
            )
            sd[f"{hp}block_forward.4.num_batches_tracked"] = np.asarray(
                0, np.int64
            )
            sd[f"{hp}block_forward.8.weight"] = np.ascontiguousarray(
                np.asarray(heads["proj"]["kernel"][i], np.float32).T
            )
            sd[f"{hp}block_forward.8.bias"] = np.asarray(
                heads["proj"]["bias"][i], np.float32
            )
        else:
            sd[f"{hp}weight"] = np.ascontiguousarray(
                np.asarray(heads["proj"]["kernel"][i], np.float32).T
            )
            sd[f"{hp}bias"] = np.asarray(heads["proj"]["bias"][i],
                                         np.float32)
    return sd


def export_reference_state_dict(
    params: dict,
    batch_stats: dict,
    headcount: int,
    use_mlp: bool = True,
    audio_stage_blocks: Tuple[int, ...] = (1, 1, 1, 1),
    ddp_prefix: str = "module.",
) -> Dict[str, np.ndarray]:
    """Full AVModel trees -> a reference ``model`` state_dict (numpy)."""
    vp, vbs = params["video_network"], batch_stats["video_network"]
    mid = np.asarray(
        vp["layer1_block0"]["conv1"]["spatial"]["conv"]["kernel"]).shape[-1]
    if mid != _midplanes(64, 64):
        logger.warning(
            "video tower midplanes deviate from torchvision r2plus1d_18 "
            "(layer1 midplanes %d != %d; --tpu_aligned_midplanes?); the "
            "exported file will not load into the reference model",
            mid, _midplanes(64, 64),
        )
    sd: Dict[str, np.ndarray] = {}
    sd.update(export_video_tower(vp, vbs))
    sd.update(export_audio_tower(
        params["audio_network"], batch_stats["audio_network"],
        stage_blocks=audio_stage_blocks,
    ))
    # linear heads (use_mlp=False) have no BN, so the batch_stats tree
    # carries no heads_v/heads_a entries
    sd.update(export_heads(params["heads_v"], batch_stats.get("heads_v", {}),
                           "v", headcount, use_mlp))
    sd.update(export_heads(params["heads_a"], batch_stats.get("heads_a", {}),
                           "a", headcount, use_mlp))
    if ddp_prefix:
        sd = {ddp_prefix + k: v for k, v in sd.items()}
    return sd


def save_reference_checkpoint(
    path: str,
    params: dict,
    batch_stats: dict,
    headcount: int,
    use_mlp: bool = True,
    audio_stage_blocks: Tuple[int, ...] = (1, 1, 1, 1),
    epoch: int = 0,
    selflabels: Optional[np.ndarray] = None,
    marginal_dists: Optional[np.ndarray] = None,
):
    """torch.save a reference-schema checkpoint. ``marginal_dists`` is the
    ``[H, K]`` marginal cache; the reference stores it as a per-head list
    of ``[K, 1]`` fp64 tensors."""
    sd = export_reference_state_dict(
        params, batch_stats, headcount, use_mlp, audio_stage_blocks
    )
    model_sd = {k: torch.from_numpy(np.array(v, copy=True))
                for k, v in sd.items()}
    dist = None
    if marginal_dists is not None:
        dist = [
            torch.from_numpy(
                np.ascontiguousarray(d, np.float64).reshape(-1, 1)
            )
            for d in np.asarray(marginal_dists)
        ]
    blob = {"epoch": int(epoch), "dist": dist, "model": model_sd}
    if selflabels is not None:
        blob["selflabels"] = torch.from_numpy(
            np.asarray(selflabels, np.int64)
        )
    torch.save(blob, path)


def model_for_state_dict(state: Dict[str, torch.Tensor]):
    """A CPU AVModel of the architecture that ``state`` (a port
    ``state_dict``) was saved from, with ``state`` loaded."""
    proj = state["heads_v.proj_weight"]  # [H, I, K]
    blocks = {k.split(".")[2] for k in state
              if k.startswith("audio_network.blocks.")}
    kind = (len(blocks), "audio_network.blocks.0.conv3.conv.weight" in state)
    if kind not in _AUDIO_BY_BLOCKS:
        raise ValueError(f"unrecognized audio tower: {len(blocks)} blocks")
    mid = state["video_network.layer1_block0.conv1.spatial.weight"].shape[0]
    model = load_model(
        audio_channels=state["audio_network.stem.conv.weight"].shape[1],
        aud_base_arch=_AUDIO_BY_BLOCKS[kind],
        use_mlp="heads_v.hidden_weight" in state,
        headcount=proj.shape[0],
        num_classes=proj.shape[2],
        midplanes_mode="parity" if mid == _midplanes(64, 64) else "aligned",
        device="cpu",
    )
    model.load_state_dict(state)
    return model


def export_our_checkpoint(ckpt_path: str, out_path: str):
    """Convert one of the port's ``checkpoint.pth`` files to the reference
    .pth layout. The architecture (head count, K, MLP heads, audio arch
    and stem channels, midplanes) is read off the saved state_dict's
    shapes."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model = model_for_state_dict(payload["model"])
    params, batch_stats = export_jax_variables(model)
    dists = payload["dist"]["dists"]
    save_reference_checkpoint(
        out_path,
        params,
        batch_stats,
        model.heads_v.headcount,
        use_mlp=model.heads_v.use_mlp,
        audio_stage_blocks=AUDIO_ARCHS[model.audio_network.arch][1],
        epoch=int(payload["epoch"]),
        selflabels=payload["selflabels"].numpy(),
        marginal_dists=None if dists is None else dists.numpy(),
    )
    logger.info("exported %s -> %s (headcount=%d, use_mlp=%s)", ckpt_path,
                out_path, model.heads_v.headcount, model.heads_v.use_mlp)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Export a port checkpoint to the reference's PyTorch "
        ".pth.tar layout (model/selflabels/dist/epoch)."
    )
    p.add_argument("checkpoint", help="path to checkpoint.pth")
    p.add_argument("output", help="output .pth.tar path")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    export_our_checkpoint(args.checkpoint, args.output)


if __name__ == "__main__":
    main()
