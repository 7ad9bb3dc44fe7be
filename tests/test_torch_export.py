"""Checkpoint exporter: our trees -> reference .pth layout must roundtrip
bit-exactly through the importer, and the saved blob must follow the
reference checkpoint schema (/root/reference/main.py:222-242)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu.models import load_model
from selavi_tpu.train.torch_export import (
    export_heads,
    export_our_checkpoint,
    export_reference_state_dict,
    save_reference_checkpoint,
)
from selavi_tpu.train.torch_import import (
    import_audio_tower,
    import_heads,
    import_video_tower,
)


@pytest.fixture(scope="module")
def model_trees():
    headcount, k = 3, 11
    model = load_model(headcount=headcount, num_classes=k)
    rng = jax.random.PRNGKey(0)
    video = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    audio = jnp.zeros((1, 40, 51, 1), jnp.float32)
    variables = model.init({"params": rng, "dropout": rng}, video, audio,
                           train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    batch_stats = jax.tree.map(np.asarray, variables["batch_stats"])
    # make BN stats non-trivial so the roundtrip can't pass by accident
    params = jax.tree.map(
        lambda a: a + np.random.default_rng(0).normal(0, 0.01, a.shape)
        .astype(a.dtype),
        params,
    )
    return headcount, k, params, batch_stats


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_export_import_roundtrip(model_trees):
    headcount, _, params, batch_stats = model_trees
    sd = export_reference_state_dict(params, batch_stats, headcount,
                                     ddp_prefix="module.")
    assert all(k.startswith("module.") for k in sd)
    stripped = {k.replace("module.", ""): v for k, v in sd.items()}

    vp, vbs = import_video_tower(stripped)
    ap, abs_ = import_audio_tower(stripped)
    hv_p, hv_bs = import_heads(stripped, "v", headcount)
    ha_p, ha_bs = import_heads(stripped, "a", headcount)
    got_params = {"video_network": vp, "audio_network": ap,
                  "heads_v": hv_p, "heads_a": ha_p}
    got_stats = {"video_network": vbs, "audio_network": abs_,
                 "heads_v": hv_bs, "heads_a": ha_bs}

    for ref_tree, got_tree, where in (
        (params, got_params, "params"),
        (batch_stats, got_stats, "batch_stats"),
    ):
        ref, got = _leaves(ref_tree), _leaves(got_tree)
        assert set(ref) == set(got), where
        for key in ref:
            np.testing.assert_array_equal(ref[key], got[key],
                                          err_msg=f"{where}{key}")


def test_exported_keys_match_torchvision_schema(model_trees):
    headcount, _, params, batch_stats = model_trees
    sd = export_reference_state_dict(params, batch_stats, headcount,
                                     ddp_prefix="")
    # spot-check the distinctive reference key shapes
    assert sd["video_network.base.stem.0.weight"].shape == (45, 3, 1, 7, 7)
    assert sd["video_network.base.layer1.0.conv1.0.3.weight"].shape[2:] == (
        3, 1, 1,
    )
    assert sd["audio_network.base.conv1.weight"].shape == (64, 1, 7, 7)
    assert "video_network.base.stem.1.num_batches_tracked" in sd
    assert sd["mlp_v0.block_forward.8.weight"].shape[1] == 512
    assert "mlp_v2.block_forward.2.weight" in sd


def test_single_head_bare_names():
    """headcount==1 must emit mlp_v. / mlp_a. without an index
    (reference model.py:201-208)."""
    k = 5
    heads_p = {"heads": {
        "hidden": {"kernel": np.zeros((1, 512, 512), np.float32)},
        "bn": {"scale": np.ones((1, 512), np.float32),
               "bias": np.zeros((1, 512), np.float32)},
        "proj": {"kernel": np.zeros((1, 512, k), np.float32),
                 "bias": np.zeros((1, k), np.float32)},
    }}
    heads_bs = {"heads": {"bn": {
        "mean": np.zeros((1, 512), np.float32),
        "var": np.ones((1, 512), np.float32),
    }}}
    sd = export_heads(heads_p, heads_bs, "v", headcount=1)
    assert "mlp_v.block_forward.2.weight" in sd
    assert not any(key.startswith("mlp_v0") for key in sd)


def test_saved_pth_schema_and_cli_roundtrip(model_trees, tmp_path):
    torch = pytest.importorskip("torch")
    headcount, k, params, batch_stats = model_trees
    selflabels = np.random.default_rng(1).integers(
        0, k, size=(32, headcount)
    )
    dists = np.random.default_rng(2).uniform(5, 15, (headcount, k))

    out = tmp_path / "exported.pth.tar"
    save_reference_checkpoint(
        str(out), params, batch_stats, headcount,
        epoch=7, selflabels=selflabels, marginal_dists=dists,
    )
    blob = torch.load(str(out), map_location="cpu", weights_only=False)
    assert blob["epoch"] == 7
    assert set(blob) == {"epoch", "dist", "model", "selflabels"}
    assert all(key.startswith("module.") for key in blob["model"])
    assert blob["selflabels"].dtype == torch.int64
    assert blob["selflabels"].shape == (32, headcount)
    assert len(blob["dist"]) == headcount
    assert blob["dist"][0].shape == (k, 1)
    assert blob["dist"][0].dtype == torch.float64
    np.testing.assert_allclose(
        blob["dist"][1].numpy()[:, 0], dists[1], rtol=0, atol=0
    )

    # the importer must accept the torch.load'ed blob end-to-end
    from selavi_tpu.train.torch_import import import_reference_checkpoint

    got_params, got_stats = import_reference_checkpoint(
        str(out), headcount=headcount
    )
    np.testing.assert_array_equal(
        got_params["heads_v"]["heads"]["proj"]["kernel"],
        params["heads_v"]["heads"]["proj"]["kernel"],
    )
    np.testing.assert_array_equal(
        got_stats["video_network"]["stem_bn1"]["bn"]["var"],
        batch_stats["video_network"]["stem_bn1"]["bn"]["var"],
    )

    # CLI path: a raw checkpoint.msgpack payload -> .pth
    from flax import serialization

    payload = {
        "epoch": 3,
        "selflabels": selflabels,
        "dist": {"dists": dists},
        "sk_counter": 2,
        "device": serialization.to_bytes({
            "step": np.asarray(10),
            "params": params,
            "batch_stats": batch_stats,
            "opt_state": {},
        }),
    }
    ckpt = tmp_path / "checkpoint.msgpack"
    with open(ckpt, "wb") as f:
        pickle.dump(payload, f)
    out2 = tmp_path / "cli.pth.tar"
    export_our_checkpoint(str(ckpt), str(out2))
    blob2 = torch.load(str(out2), map_location="cpu", weights_only=False)
    assert blob2["epoch"] == 3
    assert blob2["model"].keys() == blob["model"].keys()


def test_resnet18_audio_export_structure():
    """The audio tower's stage structure is inferred from the param keys
    (regression: a hardcoded resnet9 assumption exported resnet18/34
    weights under wrong torchvision names and silently dropped blocks)."""
    from selavi_tpu.train.torch_export import (
        _infer_audio_stage_blocks,
        export_audio_tower,
    )

    model = load_model(headcount=1, num_classes=4, aud_base_arch="resnet18")
    rng = jax.random.PRNGKey(1)
    video = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    audio = jnp.zeros((1, 40, 51, 1), jnp.float32)
    variables = model.init({"params": rng, "dropout": rng}, video, audio,
                           train=False)
    ap = jax.tree.map(np.asarray, variables["params"])["audio_network"]
    abs_ = jax.tree.map(np.asarray, variables["batch_stats"])[
        "audio_network"
    ]
    assert _infer_audio_stage_blocks(ap) == (2, 2, 2, 2)
    sd = export_audio_tower(ap, abs_, stage_blocks=(2, 2, 2, 2))
    # torchvision resnet18: layer{1..4}.{0,1}, and layer2.0 must carry
    # the 64->128 stride-2 conv with a downsample (the block the old
    # mapping mislabeled with layer1.1's 64->64 weights)
    for stage in (1, 2, 3, 4):
        for b in (0, 1):
            assert f"audio_network.base.layer{stage}.{b}.conv1.weight" in sd
    w = sd["audio_network.base.layer2.0.conv1.weight"]
    assert w.shape == (128, 64, 3, 3), w.shape
    assert "audio_network.base.layer2.0.downsample.0.weight" in sd
    assert sd["audio_network.base.layer1.1.conv1.weight"].shape == (
        64, 64, 3, 3,
    )


def test_resnet50_bottleneck_export_import_roundtrip():
    """resnet50 (Bottleneck) audio towers export to the torchvision
    Bottleneck layout (conv1..3/bn1..3 + downsample) and import back
    bit-exactly (closes the r4 NotImplementedError edge)."""
    from selavi_tpu.train.torch_export import (
        _infer_audio_stage_blocks,
        export_audio_tower,
    )
    from selavi_tpu.train.torch_import import import_audio_tower

    model = load_model(headcount=1, num_classes=4, aud_base_arch="resnet50")
    rng = jax.random.PRNGKey(2)
    video = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    audio = jnp.zeros((1, 40, 51, 1), jnp.float32)
    variables = model.init({"params": rng, "dropout": rng}, video, audio,
                           train=False)
    ap = jax.tree.map(np.asarray, variables["params"])["audio_network"]
    abs_ = jax.tree.map(np.asarray, variables["batch_stats"])[
        "audio_network"
    ]
    stage_blocks = _infer_audio_stage_blocks(ap)
    assert stage_blocks == (3, 4, 6, 3)
    sd = export_audio_tower(ap, abs_, stage_blocks=stage_blocks)
    # torchvision resnet50 shape spots: bottleneck 1x1 -> 3x3 -> 1x1 x4,
    # every stage's block 0 carries a downsample (64->256 even at stride 1)
    assert sd["audio_network.base.layer1.0.conv1.weight"].shape == (
        64, 64, 1, 1,
    )
    assert sd["audio_network.base.layer1.0.conv3.weight"].shape == (
        256, 64, 1, 1,
    )
    assert sd["audio_network.base.layer1.0.downsample.0.weight"].shape == (
        256, 64, 1, 1,
    )
    assert sd["audio_network.base.layer4.2.conv3.weight"].shape == (
        2048, 512, 1, 1,
    )
    assert "audio_network.base.layer1.1.downsample.0.weight" not in sd
    # roundtrip: import back (kind + stage structure auto-detected)
    p2, bs2 = import_audio_tower(sd)
    for a, b in zip(jax.tree.leaves(ap), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(abs_), jax.tree.leaves(bs2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_linear_head_checkpoint_exports():
    """use_mlp=False heads have no BN, so flax's batch_stats has no
    heads_v/heads_a entries — export must not KeyError (ADVICE r2)."""
    headcount, k = 2, 7
    model = load_model(headcount=headcount, num_classes=k, use_mlp=False)
    rng = jax.random.PRNGKey(0)
    video = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    audio = jnp.zeros((1, 40, 51, 1), jnp.float32)
    variables = model.init({"params": rng, "dropout": rng}, video, audio,
                           train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    batch_stats = jax.tree.map(np.asarray, variables["batch_stats"])
    assert "heads_v" not in batch_stats  # the precondition this guards
    sd = export_reference_state_dict(params, batch_stats, headcount,
                                     use_mlp=False, ddp_prefix="")
    head_keys = [key for key in sd if "mlp_v" in key or "mlp_a" in key]
    assert head_keys, sorted(sd)[:5]
    roundtrip, _ = import_heads(sd, "v", headcount, use_mlp=False)
    ours = params["heads_v"]["heads"]["proj"]
    np.testing.assert_array_equal(
        roundtrip["heads"]["proj"]["kernel"], ours["kernel"]
    )
