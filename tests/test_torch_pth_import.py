"""Import of reference-layout ``.pth`` files into the port
(``train/torch_import.py``), on the CPU:

* a port checkpoint exported by ``train/torch_export.py`` and imported
  back gives the same state_dict bit for bit (both ways are transposes
  and copies), for the resnet9 and resnet50 audio towers, headcount 1 and
  10, MLP and linear heads;
* JAX's ``import_reference_checkpoint``, moved into the port by
  ``load_jax_variables``, gives the same state_dict as the port's import
  of the same file, bit for bit;
* a file whose layout does not fit the model's architecture is refused
  before any tensor is copied;
* ``cli.get_clusters`` on the ``.pth`` (and ``.pth.tar``) that
  ``torch_export`` wrote gives the same dump as on the port checkpoint.
"""

import shutil

import numpy as np
import pytest
import torch

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu.train.torch_import import (
    import_reference_checkpoint as jax_import,
)
from selavi_tpu_torch.cli import get_clusters
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS
from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.train import torch_export, torch_import
from selavi_tpu_torch.train.checkpoint import CKPT_NAME, save_checkpoint
from selavi_tpu_torch.train.state import SelfLabelState

torch.set_num_threads(1)

H, K, N = 2, 8, 16
EVAL = (f"--ds_name synthetic --num_data_samples {N} --mlp_dim {K} "
        f"--headcount {H} --num_frames 4 --train_crop_size 32 "
        "--aud_sample_rate 16000 --aud_spec_type 1 --batch_size 8 "
        "--workers 0")


def _model(seed, **arch):
    """An AVModel whose BN statistics differ from the init (the export and
    the import must carry them)."""
    model = load_model(seed=seed, device="cpu", **arch)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for buf in model.buffers():
            buf.add_(torch.rand(buf.shape, generator=g))
    return model


def _write_checkpoint(dump, model, n=N):
    heads = model.heads_v.headcount
    sl_state = SelfLabelState(
        selflabels=np.arange(n * heads, dtype=np.int32).reshape(n, heads) % 3,
        marginals=MarginalState(dists=None), sk_counter=0, epoch=0)
    save_checkpoint(str(dump), model, torch.optim.SGD(model.parameters(),
                                                      lr=0.1), sl_state, 0)
    return dump / CKPT_NAME


ARCHS = {
    "resnet9_h1": dict(headcount=1, num_classes=K),
    "resnet9_h10": dict(headcount=10, num_classes=K),
    "resnet9_h10_linear": dict(headcount=10, num_classes=K, use_mlp=False),
    "resnet50_h10": dict(headcount=10, num_classes=K,
                         aud_base_arch="resnet50"),
    "resnet50_h1_linear": dict(headcount=1, num_classes=K, use_mlp=False,
                               aud_base_arch="resnet50"),
}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_export_then_import_is_bit_exact_and_matches_jax(tmp_path, name):
    arch = ARCHS[name]
    model = _model(1, **arch)
    pth = tmp_path / "reference.pth.tar"
    torch_export.main([str(_write_checkpoint(tmp_path, model)), str(pth)])
    ref = torch_import.read_reference_state_dict(str(pth))
    assert ref is not None and any(k.startswith("video_network.base.")
                                   for k in ref)

    fresh = load_model(seed=2, device="cpu", **arch)
    torch_import.import_reference_checkpoint(fresh, str(pth))
    want = model.state_dict()
    got = fresh.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key

    # JAX's import of the same file, moved into the port
    params, bs = jax_import(
        str(pth), headcount=arch["headcount"],
        use_mlp=arch.get("use_mlp", True),
        audio_stage_blocks=AUDIO_ARCHS[arch.get("aud_base_arch",
                                                "resnet9")][1])
    via_jax = load_model(seed=3, device="cpu", **arch)
    load_jax_variables(via_jax, params, bs)
    for key, value in via_jax.state_dict().items():
        assert torch.equal(got[key], value), key


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A headcount-2 checkpoint of the EVAL widths and its export."""
    dump = tmp_path_factory.mktemp("exported")
    model = _model(4, headcount=H, num_classes=K)
    ckpt = _write_checkpoint(dump, model)
    pth = dump / "reference.pth"
    torch_export.main([str(ckpt), str(pth)])
    yield ckpt, pth
    shutil.rmtree(dump, ignore_errors=True)


MISFITS = {
    "headcount": dict(headcount=1, num_classes=K),
    "classes": dict(headcount=H, num_classes=K + 1),
    "linear_heads": dict(headcount=H, num_classes=K, use_mlp=False),
    "audio_arch": dict(headcount=H, num_classes=K, aud_base_arch="resnet18"),
    "midplanes": dict(headcount=H, num_classes=K, midplanes_mode="aligned"),
}


@pytest.mark.parametrize("name", sorted(MISFITS))
def test_a_layout_that_does_not_fit_is_refused_before_any_copy(exported,
                                                               name):
    _, pth = exported
    model = load_model(seed=5, device="cpu", **MISFITS[name])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="does not fit the model"):
        torch_import.import_reference_checkpoint(model, str(pth))
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_a_port_checkpoint_is_no_reference_layout(exported):
    ckpt, _ = exported
    assert torch_import.read_reference_state_dict(str(ckpt)) is None
    model = load_model(seed=5, headcount=H, num_classes=K, device="cpu")
    with pytest.raises(ValueError, match="no reference-layout"):
        torch_import.import_reference_checkpoint(model, str(ckpt))


@pytest.mark.parametrize("suffix", [".pth", ".pth.tar"])
def test_get_clusters_on_the_exported_pth_gives_the_same_dump(
        exported, tmp_path, suffix):
    ckpt, pth = exported
    weights = tmp_path / f"reference{suffix}"
    weights.write_bytes(pth.read_bytes())
    dumps = []
    for path in (ckpt, weights):
        dumps.append(get_clusters.main(
            EVAL.split() + ["--weights_path", str(path), "--output_path",
                            str(tmp_path / "ps.pkl")], device="cpu"))
    (ps_v, labels, ps_a), (rps_v, rlabels, rps_a) = dumps
    assert ps_v.shape == (H, N, K) and np.isfinite(ps_v).all()
    np.testing.assert_array_equal(rps_v, ps_v)
    np.testing.assert_array_equal(rps_a, ps_a)
    np.testing.assert_array_equal(rlabels, labels)
