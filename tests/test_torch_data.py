"""The port's data path on the CPU, held against the JAX package's on the
same inputs and rng: transforms, the audio slicing and jitters, the
decoder, ``AVideoDataset``, the synthetic set's PCM mode, packed shards
(byte for byte, both ways), the factory and the loader's wire formats.

Both packages resize frames and compute host spectrograms in their C++
data runtimes when g++ built them, and in numpy twins of those kernels
otherwise. The port is held against JAX bit for bit on both routes
(``jax_runtime``): with both runtimes switched off (``jax_numpy``), and
with both built (``jax_native``). The real-media fixtures are written by
``scripts/make_real_media.py`` (cv2 mp4s and WAV sidecars); the tests that
decode them skip where cv2 is absent, as ``tests/test_real_media.py``
does.
"""

import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu import native as jax_native
from selavi_tpu_torch import native as port_native
from selavi_tpu.data import audio as jaudio
from selavi_tpu.data import dataset as jdataset
from selavi_tpu.data import decoder as jdec
from selavi_tpu.data import factory as jfactory
from selavi_tpu.data import packed as jpacked
from selavi_tpu.data import synthetic as jsynthetic
from selavi_tpu.data import transforms as jtransforms
from selavi_tpu.data.loader import DataLoader as JaxLoader
from selavi_tpu.data.loader import decode_wire_batches as jax_decode_wire
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data import audio as paudio
from selavi_tpu_torch.data import dataset as pdataset
from selavi_tpu_torch.data import decoder as pdec
from selavi_tpu_torch.data import factory as pfactory
from selavi_tpu_torch.data import packed as ppacked
from selavi_tpu_torch.data import synthetic as psynthetic
from selavi_tpu_torch.data import transforms as ptransforms
from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _host_numpy(monkeypatch):
    """Switch both packages' C++ data runtimes off: every host kernel runs
    its numpy twin."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(port_native, "_load", lambda: None)


@pytest.fixture(params=["jax_numpy", "jax_native"])
def jax_runtime(request, monkeypatch):
    """Which host route both packages run: the numpy twins, or the C++
    data runtimes as built."""
    if request.param == "jax_numpy":
        _host_numpy(monkeypatch)
    elif not (jax_native.available() and port_native.available()):
        pytest.skip("g++ did not build the C++ data runtimes here")
    return request.param


def _assert_example_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def _frames(seed, shape=(3, 48, 64, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("shape,new", [((3, 48, 64, 3), (128, 170)),
                                       ((2, 64, 64, 3), (41, 41)),
                                       ((2, 160, 160, 3), (112, 112)),
                                       ((1, 37, 53, 3), (200, 90))])
def test_resize_frames_matches_jax(shape, new, jax_runtime):
    frames = _frames(0, shape)
    ours = ptransforms.resize_frames(frames, *new)
    ref = jtransforms.resize_frames(frames, *new)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    # the numpy twins agree whichever route ran
    np.testing.assert_array_equal(ptransforms._resize_frames(frames, *new),
                                  jtransforms._resize_frames(frames, *new))


@pytest.mark.parametrize("shape", [(3, 48, 64, 3), (3, 64, 48, 3),
                                   (2, 40, 40, 3)])
def test_crops_and_scale_jitter_match_jax(shape, jax_runtime):
    frames = _frames(1, shape)

    def both(fn_name, *args, seed=None):
        out = []
        for mod in (ptransforms, jtransforms):
            extra = () if seed is None else (np.random.default_rng(seed),)
            out.append(getattr(mod, fn_name)(frames, *args, *extra))
        return out

    for name, args, seed in (
            ("random_short_side_scale_jitter", (36, 45), 3),
            ("resize_short_side", (36,), None),
            ("random_crop", (32,), 4),
            ("uniform_crop", (32, 0), None),
            ("uniform_crop", (32, 1), None),
            ("uniform_crop", (32, 2), None),
            ("center_crop", (32,), None)):
        ours, ref = both(name, *args, seed=seed)
        assert ours.shape == ref.shape, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)


@pytest.mark.parametrize("spatial_idx", [-1, 0, 1, 2, 3, 4, 5])
def test_spatial_sampling_matches_jax(spatial_idx, jax_runtime):
    frames = _frames(2)
    kw = dict(spatial_idx=spatial_idx, min_scale=36, max_scale=45,
              crop_size=32)
    rngs = [np.random.default_rng(9), np.random.default_rng(9)]
    ours = ptransforms.spatial_sampling(frames, rng=rngs[0], **kw)
    ref = jtransforms.spatial_sampling(frames, rng=rngs[1], **kw)
    assert ours.shape == ref.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(ours, ref)
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


def test_lighting_jitter_and_scale_range_match_jax():
    frames = _frames(3).astype(np.float32)
    eigval = [0.2175, 0.0188, 0.0045]
    eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]
    for alphastd in (0.0, 0.1):
        ours = ptransforms.lighting_jitter(frames, alphastd, eigval, eigvec,
                                           np.random.default_rng(5))
        ref = jtransforms.lighting_jitter(frames, alphastd, eigval, eigvec,
                                          np.random.default_rng(5))
        np.testing.assert_array_equal(ours, ref)
    for crop in (16, 32, 64, 112, 128, 160, 224):
        assert (ptransforms.train_scale_range(crop)
                == jtransforms.train_scale_range(crop))


# ----------------------------------------------------------------- audio

@pytest.mark.parametrize("volume", [False, True])
@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("spec_type", [1, 2])
def test_get_spec_jitters_match_jax(volume, temporal, spec_type,
                                    jax_runtime):
    wav = (np.random.default_rng(0).standard_normal(SR * 3) * 3000
           ).astype(np.int16)
    rngs = [np.random.default_rng(11), np.random.default_rng(11)]
    kw = dict(num_sec=1, sample_rate=SR, aud_spec_type=spec_type,
              use_volume_jittering=volume, use_temporal_jittering=temporal,
              z_normalize=True)
    ours = paudio.get_spec(wav, 0.3, rng=rngs[0], **kw)
    ref = jaudio.get_spec(wav, 0.3, rng=rngs[1], **kw)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    # the same draws, in the same order
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


@pytest.mark.parametrize("nfilt", [40, 257])
@pytest.mark.parametrize("sample_rate", [16000, 48000])
def test_logfbank_fast_matches_jax(nfilt, sample_rate, jax_runtime):
    """``get_spec``'s filterbank: the C++ runtime's float32 FFT (one
    sample, one thread) in both packages, or numpy float64 in both."""
    wav = (np.random.default_rng(nfilt).standard_normal(sample_rate) * 3000
           ).astype(np.float64)
    ours = paudio._logfbank_fast(wav, sample_rate, nfilt)
    ref = jaudio._logfbank_fast(wav, sample_rate, nfilt)
    assert ours.shape == ref.shape == (99, nfilt)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == (np.float32 if jax_runtime == "jax_native"
                          else np.float64)


@pytest.mark.parametrize("fr_sec", [-0.2, 0.0, 0.75, 2.9])
@pytest.mark.parametrize("jitter", [False, True])
def test_slice_clip_pcm_matches_jax(fr_sec, jitter):
    wav = (np.random.default_rng(1).standard_normal(SR * 2 + 77) * 3000
           ).astype(np.int16)
    rngs = [np.random.default_rng(12), np.random.default_rng(12)]
    kw = dict(num_sec=1, sample_rate=SR, use_volume_jittering=jitter,
              use_temporal_jittering=jitter)
    ours = paudio.slice_clip_pcm(wav, fr_sec, rng=rngs[0], **kw)
    ref = jaudio.slice_clip_pcm(wav, fr_sec, rng=rngs[1], **kw)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (SR,)
    np.testing.assert_array_equal(ours, ref)
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


# --------------------------------------------------------------- decoder

def test_clip_index_functions_match_jax():
    frames = np.arange(50)[:, None, None, None] * np.ones((1, 2, 2, 3),
                                                          np.uint8)
    for video_size, clip_size in ((300, 30.0), (20, 30.0), (91, 45.5)):
        for clip_idx, num_clips in ((-1, 10), (0, 10), (3, 10), (9, 10),
                                    (500, 1000)):
            rngs = [np.random.default_rng(7), np.random.default_rng(7)]
            ours = pdec.get_start_end_idx(video_size, clip_size, clip_idx,
                                          num_clips, rngs[0])
            ref = jdec.get_start_end_idx(video_size, clip_size, clip_idx,
                                         num_clips, rngs[1])
            assert ours == ref
            np.testing.assert_array_equal(
                pdec.temporal_sampling(frames, *ours, 8),
                jdec.temporal_sampling(frames, *ref, 8))
            assert (pdec.clip_seconds(ours[0], 29.97)
                    == jdec.clip_seconds(ref[0], 29.97))
    assert pdec.clip_seconds(10, 0) == jdec.clip_seconds(10, 0) == 0.0


def _write_wav(path, pcm, rate, width=2, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("case", ["mono16", "stereo16", "resample",
                                  "u8", "s32"])
def test_decode_audio_wav_matches_jax(tmp_path, case):
    rng = np.random.default_rng(2)
    mono = (rng.standard_normal(4000) * 4000).astype(np.int16)
    path = tmp_path / "a.wav"
    if case == "mono16":
        _write_wav(path, mono, SR)
    elif case == "stereo16":
        _write_wav(path, np.stack([mono, mono // 3], 1), SR, channels=2)
    elif case == "resample":
        _write_wav(path, mono, 24000)
    elif case == "u8":
        _write_wav(path, rng.integers(0, 256, 4000, np.uint8), SR, width=1)
    else:
        _write_wav(path, mono.astype(np.int32) << 16, SR, width=4)
    ours = pdec.decode_audio_wav(str(path), SR)
    ref = jdec.decode_audio_wav(str(path), SR)
    assert ours.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(ours, ref)
    if case in ("mono16", "s32"):
        np.testing.assert_array_equal(ours, mono)  # the round trip
    if case == "resample":
        assert len(ours) == round(4000 * SR / 24000)
    assert pdec.decode_audio_wav(str(tmp_path / "none.wav"), SR) is None


def test_audio_sidecar_dispatch_matches_jax(tmp_path, monkeypatch):
    for mod in (pdec, jdec):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: False)
        monkeypatch.setattr(mod, "have_pyav", lambda: False)
    pcm = (np.random.default_rng(3).standard_normal(3000) * 2000
           ).astype(np.int16)
    (tmp_path / "v.mp4").write_bytes(b"")
    (tmp_path / "w.mp4").write_bytes(b"")
    _write_wav(tmp_path / "v.wav", pcm, SR)
    for name in ("v.mp4", "w.mp4", "v.wav", "V.WAV"):
        path = str(tmp_path / name)
        assert pdec._sidecar_wav(path) == jdec._sidecar_wav(path)
    assert pdec._sidecar_wav(str(tmp_path / "v.mp4")) == str(tmp_path /
                                                             "v.wav")
    np.testing.assert_array_equal(
        pdec.decode_audio(str(tmp_path / "v.mp4"), SR), pcm)
    assert pdec.decode_audio(str(tmp_path / "w.mp4"), SR) is None
    assert jdec.decode_audio(str(tmp_path / "w.mp4"), SR) is None


def test_decode_video_without_a_backend_returns_none(monkeypatch):
    for name in ("have_pyav", "have_ffmpeg", "have_cv2"):
        monkeypatch.setattr(pdec, name, lambda: False)
    assert pdec.decode_video("/nonexistent.mp4", 1, 8, -1, 10) == (
        None, 0.0, 0.0)


def test_probe_valid_without_ffprobe(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(pdec, "_warned_no_ffprobe", False)
    assert pdec.probe_valid("/nonexistent.mp4") is True
    assert pdec.probe_video_meta("/nonexistent.mp4") is None
    with pytest.raises(RuntimeError, match="strict_probe"):
        pdec.probe_valid("/nonexistent.mp4", strict=True)
    with pytest.raises(RuntimeError, match="strict_probe"):
        jdec.probe_valid("/nonexistent.mp4", strict=True)


# ---------------------------------------------------- real-media fixtures

@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """6 cv2 mp4s (3 classes, 64x64, 1.5 s at 30 fps) with 16 kHz WAV
    sidecars, from scripts/make_real_media.py, plus one corrupt file."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("media")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_real_media.py"),
         "--output", str(root), "--num_videos", "6", "--num_classes", "3",
         "--frame_size", "64", "--duration", "1.5", "--aud_sample_rate",
         str(SR), "--seed", "4"],
        check=True, capture_output=True, timeout=300)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_cv2_decode_matches_jax(media):
    path = sorted((media / "train").glob("*/*.mp4"))[0]
    for clip_idx, num_clips in ((-1, 10), (0, 10), (9, 10), (500, 1000)):
        rngs = [np.random.default_rng(8), np.random.default_rng(8)]
        ours = pdec.decode_video(str(path), 1, 8, clip_idx, num_clips,
                                 rng=rngs[0])
        ref = jdec.decode_video(str(path), 1, 8, clip_idx, num_clips,
                                rng=rngs[1])
        assert ours[0].shape == (8, 64, 64, 3) and ours[0].dtype == np.uint8
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[1:] == ref[1:]


def _ds_kwargs(media, data_path, **kw):
    base = dict(ds_name="folder", root_dir=str(media), mode="train",
                path_to_data_dir=str(data_path), num_frames=8,
                train_crop_size=32, test_crop_size=32, num_sec=1,
                aud_sample_rate=SR, aud_spec_type=1, z_normalize=True,
                num_ensemble_views=2, num_spatial_crops=3)
    base.update(kw)
    return base


def _both_datasets(media, tmp_path, **kw):
    ours = pdataset.AVideoDataset(**_ds_kwargs(media, tmp_path / "p", **kw))
    ref = jdataset.AVideoDataset(**_ds_kwargs(media, tmp_path / "j", **kw))
    return ours, ref


@pytest.mark.parametrize("mode", ["train", "test"])
def test_path_list_cache_is_jax_bytes(media, tmp_path, mode):
    if mode == "test":
        shutil.copytree(media / "train", media / mode, dirs_exist_ok=True)
    ours, ref = _both_datasets(media, tmp_path, mode=mode)
    name = f"folder_{mode}.txt"
    assert ((tmp_path / "p" / name).read_bytes()
            == (tmp_path / "j" / name).read_bytes())
    assert ours._path_to_videos == ref._path_to_videos
    assert ours._labels == ref._labels
    assert ours._spatial_temporal_idx == ref._spatial_temporal_idx
    assert ours._vid_indices == ref._vid_indices
    assert list(ours.valid_indices) == list(ref.valid_indices)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert len(ours) == 6 * (6 if mode == "test" else 1)
    # each package reads the other's cache
    again = jdataset.AVideoDataset(**_ds_kwargs(media, tmp_path / "p",
                                                mode=mode))
    assert again._path_to_videos == ours._path_to_videos


@pytest.mark.parametrize("return_pcm", [False, True])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_get_example_matches_jax(media, tmp_path, jax_runtime, return_pcm,
                                 dual, mode):
    if mode == "test":
        shutil.copytree(media / "train", media / mode, dirs_exist_ok=True)
    ours, ref = _both_datasets(
        media, tmp_path, mode=mode, return_pcm=return_pcm, dual_data=dual,
        use_volume_jittering=True, use_temporal_jittering=True)
    for index in range(0, len(ours), max(len(ours) // 4, 1)):
        rngs = [np.random.default_rng((5, index)),
                np.random.default_rng((5, index))]
        a = ours.get_example(index, rngs[0])
        b = ref.get_example(index, rngs[1])
        _assert_example_equal(a, b)
        clips = 2 if dual and mode == "train" else 1
        assert a["video"].shape == (8 * clips, 32, 32, 3)
        if return_pcm:
            assert a["audio_pcm"].shape == ((SR,) if clips == 1
                                            else (2, SR))
        else:
            assert a["audio"].shape == ((40, 99) if clips == 1
                                        else (40, 99, 2))
        assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


def test_decode_failures_resample_then_raise(media, tmp_path, monkeypatch):
    _host_numpy(monkeypatch)
    root = tmp_path / "bad"
    shutil.copytree(media / "train", root / "train")
    bad = sorted((root / "train").iterdir())[0] / "aaa_corrupt.mp4"
    bad.write_bytes(b"not a video" * 100)
    ours, ref = _both_datasets(root, tmp_path)
    index = [i for i, p in enumerate(ours._path_to_videos)
             if p.endswith("aaa_corrupt.mp4")][0]
    rngs = [np.random.default_rng(6), np.random.default_rng(6)]
    a, b = ours.get_example(index, rngs[0]), ref.get_example(index, rngs[1])
    _assert_example_equal(a, b)
    assert a["index"] != index  # resampled to a file that decodes

    for p in (root / "train").glob("*/*.mp4"):
        p.write_bytes(b"garbage")
    for cls, kw in ((pdataset, {}), (jdataset, {})):
        ds = cls.AVideoDataset(**_ds_kwargs(root, tmp_path / "x",
                                            decode_retries=2, **kw))
        with pytest.raises(RuntimeError,
                           match="3 consecutive decode failures"):
            ds.get_example(0, np.random.default_rng(0))


def test_validity_cache_is_jax_pickle(media, tmp_path, monkeypatch):
    """The AV-validity cache of the datasets that probe (here 'ave'):
    the port writes JAX's pickle of JAX's filter_videos result, and the
    JAX dataset reads the port's caches."""
    root = tmp_path / "ave"
    shutil.copytree(media / "train", root / "train")
    monkeypatch.setattr(shutil, "which", lambda name: None)  # no ffprobe
    ours = pdataset.AVideoDataset(**_ds_kwargs(root, tmp_path / "d",
                                               ds_name="ave"))
    expected = jdataset.filter_videos(ours._path_to_videos)
    assert (tmp_path / "d" / "ave_valid.pkl").read_bytes() == pickle.dumps(
        expected, protocol=pickle.HIGHEST_PROTOCOL)
    assert pdataset.filter_videos(ours._path_to_videos) == expected
    ref = jdataset.AVideoDataset(**_ds_kwargs(root, tmp_path / "d",
                                              ds_name="ave"))
    assert list(ref.valid_indices) == list(ours.valid_indices)
    assert ours.num_data_samples == jdataset.DATASET_SIZES[("ave", "train")]


def _empty_tree(root, classes, per_class=2, ext="mp4"):
    for c in classes:
        d = root / c
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            (d / f"{c}_v{i}.{ext}").write_bytes(b"")


def test_kinetics_sound_filter_matches_jax(tmp_path):
    classes = ["abseiling", "playing_drums", "bowling", "zumba", "singing"]
    _empty_tree(tmp_path / "k" / "train", classes)
    lists = {}
    for name, mod in (("p", pdataset), ("j", jdataset)):
        data = tmp_path / name
        data.mkdir()
        with open(data / "kinetics_sound_valid.pkl", "wb") as f:
            pickle.dump(list(range(6)), f)
        ds = mod.AVideoDataset(ds_name="kinetics_sound",
                               root_dir=str(tmp_path / "k"),
                               path_to_data_dir=str(data))
        lists[name] = (data / "kinetics_sound_train.txt").read_bytes()
        assert {p.split("/")[-2] for p in ds._path_to_videos} == {
            "playing_drums", "bowling", "singing"}
    assert lists["p"] == lists["j"]
    assert pdataset.SOUND_ONLY_CLASSES_KINETICS == (
        jdataset.SOUND_ONLY_CLASSES_KINETICS)
    assert pdataset.DATASET_SIZES == jdataset.DATASET_SIZES
    assert pdataset.NUM_CLUSTERS == jdataset.NUM_CLUSTERS


@pytest.mark.parametrize("ds_name", ["ucf101", "hmdb51"])
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("fold", [1, 2])
def test_ucf_hmdb_folds_match_jax(tmp_path, ds_name, mode, fold):
    classes = ["Archery", "Bowling", "Diving"]
    videos = tmp_path / "videos"
    _empty_tree(videos, classes, per_class=3, ext="avi")
    files = sorted(p.relative_to(videos).as_posix()
                   for p in videos.glob("*/*.avi"))
    if ds_name == "ucf101":
        ann = tmp_path / "ucfTrainTestlist"
        ann.mkdir()
        for f in (1, 2):
            test = [x for i, x in enumerate(files) if i % 3 == f - 1]
            (ann / f"trainlist{f:02d}.txt").write_text("".join(
                f"{x} 1\n" for x in files if x not in test))
            (ann / f"testlist{f:02d}.txt").write_text("".join(
                f"/{x}\n" for x in test))
    else:
        ann = tmp_path / "splits"
        ann.mkdir()
        for f in (1, 2):
            for c in classes:
                lines = [f"{os.path.basename(x)} {1 + (i % 3 == f - 1)}"
                         for i, x in enumerate(files) if x.startswith(c)]
                (ann / f"{c}_test_split{f}.txt").write_text(
                    "\n".join(lines) + "\n")
    out = []
    for name, mod in (("p", pdataset), ("j", jdataset)):
        ds = mod.AVideoDataset(ds_name=ds_name, root_dir=str(videos),
                               mode=mode, fold=fold,
                               path_to_data_dir=str(tmp_path / name),
                               num_ensemble_views=1, num_spatial_crops=1)
        out.append((list(ds.valid_indices), ds._path_to_videos,
                    list(ds.labels)))
    assert out[0] == out[1]
    assert 0 < len(out[0][0]) < len(files)


# ------------------------------------------------------ synthetic and packed

def _synthetic(mod, n=6, classes=4, crop=40, pcm=True, seed=3):
    return mod.SyntheticAVDataset(num_samples=n, num_classes=classes,
                                  num_frames=4, crop_size=crop,
                                  aud_sample_rate=SR, aud_spec_type=1,
                                  seed=seed, return_pcm=pcm)


@pytest.mark.parametrize("classes", [4, 20])  # signature v1 and v2
def test_synthetic_pcm_is_jax_bit_for_bit(classes):
    ours = _synthetic(psynthetic, classes=classes)
    ref = _synthetic(jsynthetic, classes=classes)
    for i in range(len(ours)):
        _assert_example_equal(
            ours.get_example(i, np.random.default_rng((1, i))),
            ref.get_example(i, np.random.default_rng((1, i))))


@pytest.mark.parametrize("video_format", ["rgb", "yuv420"])
@pytest.mark.parametrize("pcm_dtype", ["float32", "int16"])
def test_packed_shard_is_jax_bytes(tmp_path, video_format, pcm_dtype):
    kw = dict(seed=2, video_format=video_format, pcm_dtype=pcm_dtype)
    meta = ppacked.write_packed_shard(_synthetic(psynthetic),
                                      str(tmp_path / "p.pack"), **kw)
    jmeta = jpacked.write_packed_shard(_synthetic(jsynthetic),
                                       str(tmp_path / "j.pack"), **kw)
    assert meta == jmeta
    assert ((tmp_path / "p.pack").read_bytes()
            == (tmp_path / "j.pack").read_bytes())


@pytest.mark.parametrize("video_format", ["rgb", "yuv420"])
@pytest.mark.parametrize("pcm_dtype", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_packed_reads_a_jax_shard_as_jax_does(tmp_path, video_format,
                                              pcm_dtype, mode):
    path = str(tmp_path / "j.pack")
    jpacked.write_packed_shard(_synthetic(jsynthetic, crop=40), path,
                               video_format=video_format,
                               pcm_dtype=pcm_dtype)
    kw = dict(crop_size=32, mode=mode, num_sec=1, sample_rate=SR // 2)
    ours = ppacked.PackedAVDataset(path, **kw)
    ref = jpacked.PackedAVDataset(path, **kw)
    assert len(ours) == len(ref) == 6
    np.testing.assert_array_equal(ours.labels, ref.labels)
    for i in range(len(ours)):
        rngs = [np.random.default_rng((4, i)), np.random.default_rng((4, i))]
        a, b = ours.get_example(i, rngs[0]), ref.get_example(i, rngs[1])
        _assert_example_equal(a, b)
        assert a["audio_pcm"].shape == (SR // 2,)
        assert a["audio_pcm"].dtype == np.dtype(pcm_dtype)
    ours.close()
    ref.close()


def test_packed_yuv_crop_is_even_aligned(tmp_path):
    path = str(tmp_path / "p.pack")
    ppacked.write_packed_shard(_synthetic(psynthetic, n=2, crop=40), path,
                               video_format="yuv420")
    full = ppacked.PackedAVDataset(path)
    crop = ppacked.PackedAVDataset(path, crop_size=30)
    whole = full.get_example(0)
    offsets = set()
    for seed in range(40):
        ex = crop.get_example(0, np.random.default_rng(seed))
        y, uv = ex["video_y"], ex["video_uv"]
        assert y.shape == (4, 30, 30) and uv.shape == (4, 15, 15, 2)
        hits = [(i, j) for i in range(11) for j in range(11)
                if np.array_equal(whole["video_y"][:, i:i + 30, j:j + 30],
                                  y)]
        assert hits
        i0, j0 = hits[0]
        assert i0 % 2 == 0 and j0 % 2 == 0
        np.testing.assert_array_equal(
            whole["video_uv"][:, i0 // 2:i0 // 2 + 15, j0 // 2:j0 // 2 + 15],
            uv)
        offsets.add((i0, j0))
    assert len(offsets) > 1  # the crop moves
    full.close()
    crop.close()


def test_rgb_to_yuv420_matches_jax():
    video = _frames(5, (3, 16, 24, 3))
    for a, b in zip(ppacked.rgb_to_yuv420(video),
                    jpacked.rgb_to_yuv420(video)):
        np.testing.assert_array_equal(a, b)


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pack_dataset_cli_writes_the_jax_scripts_bytes(tmp_path, capsys):
    from selavi_tpu_torch.cli import pack_dataset

    argv = ("--ds_name synthetic --num_data_samples 5 --num_frames 4 "
            "--train_crop_size 40 --aud_sample_rate 16000 --aud_spec_type 1 "
            "--mlp_dim 8 --pack_video_format yuv420 --pack_pcm_dtype int16 "
            "--output").split()
    meta = pack_dataset.main(argv + [str(tmp_path / "p.pack")])
    _load_jax_script("pack_dataset").main(argv + [str(tmp_path / "j.pack")])
    assert meta["n"] == 5 and meta["video_format"] == "yuv420"
    assert ((tmp_path / "p.pack").read_bytes()
            == (tmp_path / "j.pack").read_bytes())
    assert "packed 5 samples" in capsys.readouterr().out


# ---------------------------------------------------- factory and loader

def _args(extra):
    return parse_arguments().parse_args(extra.split())


def test_factory_builds_every_kind(tmp_path, media):
    path = str(tmp_path / "s.pack")
    ppacked.write_packed_shard(_synthetic(psynthetic), path)
    common = ("--num_frames 8 --train_crop_size 32 --aud_sample_rate 16000 "
              "--aud_spec_type 1 --mlp_dim 8 --z_normalize true")
    kinds = {
        "packed": f"--ds_name packed --root_dir {path}",
        "synthetic": "--ds_name synthetic --num_data_samples 4",
        "folder": f"--ds_name folder --root_dir {media} "
                  f"--data_path {tmp_path / 'data'}",
    }
    for kind, flags in kinds.items():
        for pcm in (False, True):
            args = _args(f"{flags} {common} --device_spectrogram {pcm}")
            for eval_mode in (False, True):
                ours = pfactory.build_dataset(args, eval_mode=eval_mode)
                ref = jfactory.build_dataset(args, eval_mode=eval_mode)
                assert type(ours).__name__ == type(ref).__name__
                assert len(ours) == len(ref)
                a = ours.get_example(1, np.random.default_rng(3))
                b = ref.get_example(1, np.random.default_rng(3))
                _assert_example_equal(a, b)
        assert pfactory.audio_cfg_from_args(args) == (
            jfactory.audio_cfg_from_args(args))


def test_add_dataset_flags_matches_jax():
    import argparse

    from selavi_tpu.config import bool_flag as jax_bool_flag
    from selavi_tpu_torch.config import bool_flag

    parsers = []
    for add, flag in ((pfactory.add_dataset_flags, bool_flag),
                      (jfactory.add_dataset_flags, jax_bool_flag)):
        p = argparse.ArgumentParser()
        p.register("type", "bool", flag)
        parsers.append(add(p))
    argv = "--ds_name packed --device_spectrogram true --mlp_dim 9".split()
    assert vars(parsers[0].parse_args([])) == vars(parsers[1].parse_args([]))
    assert vars(parsers[0].parse_args(argv)) == vars(
        parsers[1].parse_args(argv))


@pytest.mark.parametrize("pcm_dtype", ["float32", "int16"])
@pytest.mark.parametrize("video_format", ["rgb", "yuv420"])
def test_loader_wire_batches_match_jax(tmp_path, pcm_dtype, video_format):
    path = str(tmp_path / "s.pack")
    ppacked.write_packed_shard(_synthetic(psynthetic, n=8), path,
                               video_format=video_format,
                               pcm_dtype=pcm_dtype)
    ds = ppacked.PackedAVDataset(path, crop_size=32, num_sec=1,
                                 sample_rate=SR // 2)
    ours = list(DataLoader(ds, batch_size=4, seed=3))
    ref = list(JaxLoader(ds, batch_size=4, seed=3))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
            if key not in ("label", "index", "vid_idx"):
                assert a[key].numpy().dtype == b[key].dtype, key
        assert ("video_y" in a) == (video_format == "yuv420")
        assert a["audio_pcm"].dtype == getattr(torch, pcm_dtype)
    for a, b in zip(map(decode_wire_batch, ours), jax_decode_wire(iter(ref))):
        assert sorted(a) == sorted(b)
        assert a["video"].dtype == torch.uint8
        assert a["audio_pcm"].dtype == torch.float32
        for key in b:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    ds.close()
