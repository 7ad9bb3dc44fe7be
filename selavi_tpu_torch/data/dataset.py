"""AVideoDataset: real-media audio-video dataset with reference-compatible
artifacts.

The port's copy of ``selavi_tpu/data/dataset.py`` (the reference's
datasets/AVideoDataset.py:134-461):

* path-list cache ``{data_path}/{ds}_{mode}.txt`` built from
  ``{root}/{mode}/{class}/{vid}``, classes sorted (labels = class index),
  byte-identical to the JAX package's, so both packages share one cache;
* Kinetics-Sound = the 32 sound-relevant Kinetics class names filter;
* audio-validity cache ``{data_path}/{ds}_valid.pkl`` (parallel ffprobe:
  has audio + video streams, both > 1.1 s), in the same pickle schema;
* hard-coded dataset sizes (vggsound 170752/14032, kinetics 230976/18968,
  kinetics_sound 22408, ave 3328);
* UCF-101 / HMDB-51 official fold files;
* train mode: random temporal clip + scale-jitter + random crop; test mode
  enumerates ``num_ensemble_views x num_spatial_crops`` deterministic
  clips; ``dual_data`` concatenates two clips along time;
* ``get_example`` returns the reference's ``__getitem__`` tuple contract as
  a dict: frames [T,H,W,3] u8 (the card does normalize/flip/jitter), audio
  log-filterbank spec [nfilt, T] or, with ``return_pcm``, the raw clip
  waveform, label, capped index, vid_idx.

Decode needs PyAV, the ffmpeg binary or cv2 (``data/decoder.py`` gates
them); all list/fold/cache logic is pure Python.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import Optional

import numpy as np

from selavi_tpu_torch.data import decoder as dec
from selavi_tpu_torch.data.audio import get_spec, slice_clip_pcm
from selavi_tpu_torch.data.transforms import spatial_sampling, train_scale_range

logger = logging.getLogger(__name__)

DATASET_SIZES = {
    ("vggsound", "train"): 170752,
    ("vggsound", "test"): 14032,
    ("kinetics", "train"): 230976,
    ("kinetics", "test"): 18968,
    ("kinetics_sound", "train"): 22408,
    ("kinetics_sound", "test"): 22408,
    ("ave", "train"): 3328,
    ("ave", "test"): 3328,
}

# the 32 sound-relevant Kinetics classes (reference AVideoDataset.py:246-255)
SOUND_ONLY_CLASSES_KINETICS = [
    "blowing_nose", "blowing_out_candles", "bowling", "chopping_wood",
    "dribbling_basketball", "laughing", "mowing_lawn", "playing_accordion",
    "playing_bagpipes", "playing_bass_guitar", "playing_clarinet",
    "playing_drums", "playing_guitar", "playing_harmonica",
    "playing_keyboard", "playing_organ", "playing_piano",
    "playing_saxophone", "playing_trombone", "playing_trumpet",
    "playing_violin", "playing_xylophone", "ripping_paper",
    "shoveling_snow", "shuffling_cards", "singing", "stomping_grapes",
    "strumming_guitar", "tap_dancing", "tapping_guitar", "tapping_pen",
    "tickling",
]

NUM_CLUSTERS = {  # eval-tool defaults (reference get_clusters.py:267-291)
    "vggsound": 309,
    "kinetics": 400,
    "kinetics_sound": 32,
    "ave": 28,
}


def select_fold_ucf101(
    root: str, video_list, annotation_path: str, fold: int, train: bool
):
    """Official UCF-101 fold membership (reference AVideoDataset.py:57-75)."""
    name = "train" if train else "test"
    path = os.path.join(annotation_path, f"{name}list{fold:02d}.txt")
    with open(path) as f:
        selected = {
            line.strip().split(" ")[0].lstrip("/")
            for line in f
            if line.strip()
        }
    return [
        i
        for i in range(len(video_list))
        if video_list[i][len(root):].lstrip("/") in selected
    ]


def select_fold_hmdb51(video_list, annotation_path: str, fold: int, train: bool):
    """Official HMDB-51 fold membership (reference AVideoDataset.py:35-54)."""
    target_tag = 1 if train else 2
    selected = set()
    for path in glob.glob(
        os.path.join(annotation_path, f"*test_split{fold}.txt")
    ):
        with open(path) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) >= 2 and int(parts[1]) == target_tag:
                    selected.add(parts[0])
    return [
        i
        for i in range(len(video_list))
        if os.path.basename(video_list[i]) in selected
    ]


def filter_videos(vid_paths, n_jobs: int = 30, strict: bool = False):
    """Parallel audio-validity probe (reference AVideoDataset.py:100-103).

    Threads, as the JAX package's joblib call asks for (``prefer=
    "threads"``): the probe waits on an ffprobe subprocess with the GIL
    released. The port does not depend on joblib, so it uses the
    standard library's pool; the result is the same ordered index list.
    """
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(n_jobs) as pool:
        flags = list(pool.map(
            lambda p: dec.probe_valid(p, strict=strict), vid_paths))
    return [i for i, ok in enumerate(flags) if ok]


class AVideoDataset:
    def __init__(
        self,
        ds_name: str = "kinetics",
        root_dir: str = "/path/to/kinetics",
        mode: str = "train",
        num_frames: int = 30,
        sample_rate: int = 1,
        num_train_clips: int = 1,
        train_crop_size: int = 112,
        test_crop_size: int = 112,
        num_spatial_crops: int = 3,
        num_ensemble_views: int = 10,
        path_to_data_dir: str = "datasets/data",
        num_data_samples: Optional[int] = None,
        fold: int = 1,
        colorjitter: bool = False,
        use_grayscale: bool = False,
        use_gaussian: bool = False,
        dual_data: bool = False,
        temp_jitter: bool = True,
        center_crop: bool = False,
        target_fps: int = 30,
        decode_audio: bool = True,
        num_sec: int = 1,
        aud_sample_rate: int = 48000,
        aud_spec_type: int = 1,
        use_volume_jittering: bool = False,
        use_temporal_jittering: bool = False,
        z_normalize: bool = False,
        annotation_path: Optional[str] = None,
        seed: int = 0,
        return_pcm: bool = False,
        decode_retries: int = 10,
        strict_probe: bool = False,
        **_unused,
    ):
        assert mode in ("train", "val", "test"), mode
        self.ds_name = ds_name
        self.name = ds_name
        self.mode = mode
        self.num_frames = num_frames
        self.sample_rate = sample_rate
        self.num_train_clips = num_train_clips
        self.train_crop_size = train_crop_size
        self.test_crop_size = test_crop_size
        self.num_spatial_crops = num_spatial_crops
        self.num_ensemble_views = num_ensemble_views
        self.path_to_data_dir = path_to_data_dir
        self.colorjitter = colorjitter
        self.use_grayscale = use_grayscale
        self.use_gaussian = use_gaussian
        self.dual_data = dual_data
        self.temp_jitter = temp_jitter
        self.center_crop = center_crop
        self.target_fps = target_fps
        self.decode_audio = decode_audio
        self.num_sec = num_sec
        self.aud_sample_rate = aud_sample_rate
        self.aud_spec_type = aud_spec_type
        self.use_volume_jittering = use_volume_jittering
        self.use_temporal_jittering = use_temporal_jittering
        self.z_normalize = z_normalize
        self.return_pcm = return_pcm
        self.decode_retries = decode_retries
        self.fold = fold
        self.annotation_path = annotation_path
        self.strict_probe = strict_probe
        self.seed = seed

        key = (ds_name, "train" if mode == "train" else "test")
        self.num_data_samples = DATASET_SIZES.get(key, num_data_samples)
        if num_data_samples is not None:
            self.num_data_samples = num_data_samples

        self.data_prefix = (
            root_dir
            if ds_name in ("ucf101", "hmdb51")
            else os.path.join(root_dir, mode)
        )
        self.train_jitter_scales = train_scale_range(train_crop_size)

        if mode in ("train", "val"):
            self._num_clips = num_train_clips
        else:
            self._num_clips = num_ensemble_views * num_spatial_crops

        classes = sorted(glob.glob(os.path.join(self.data_prefix, "*")))
        classes = [os.path.basename(c) for c in classes]
        self.class_to_idx = {c: i for i, c in enumerate(classes)}

        self._construct_loader()

    # ------------------------------------------------------------------
    def _construct_loader(self):
        os.makedirs(self.path_to_data_dir, exist_ok=True)
        path_to_file = os.path.join(
            self.path_to_data_dir, f"{self.ds_name}_{self.mode}.txt"
        )
        if not os.path.exists(path_to_file):
            files = sorted(glob.glob(os.path.join(self.data_prefix, "*", "*")))
            # demuxed-audio sidecars (<stem>.wav next to the container,
            # decoder._sidecar_wav) are not dataset entries of their own
            files = [p for p in files if not p.lower().endswith(".wav")]
            with open(path_to_file, "w") as f:
                for item in files:
                    if self.ds_name == "kinetics_sound":
                        cls = item.split("/")[-2]
                        if cls not in SOUND_ONLY_CLASSES_KINETICS:
                            continue
                    f.write("%s\n" % item)

        self._path_to_videos = []
        self._labels = []
        self._spatial_temporal_idx = []
        self._vid_indices = []
        with open(path_to_file) as f:
            for clip_idx, path in enumerate(f.read().splitlines()):
                for idx in range(self._num_clips):
                    self._path_to_videos.append(
                        os.path.join(self.data_prefix, path)
                    )
                    cls = path.split("/")[-2]
                    self._labels.append(int(self.class_to_idx.get(cls, -1)))
                    self._spatial_temporal_idx.append(idx)
                    self._vid_indices.append(clip_idx)
        assert len(self._path_to_videos) > 0, (
            f"Failed to load {self.ds_name} split {self.mode} from "
            f"{path_to_file}"
        )

        if self.ds_name in ("kinetics", "vggsound", "ave", "kinetics_sound"):
            valid_file = os.path.join(
                self.path_to_data_dir, f"{self.ds_name}_valid.pkl"
            )
            if os.path.exists(valid_file):
                with open(valid_file, "rb") as h:
                    self.valid_indices = pickle.load(h)
            else:
                self.valid_indices = filter_videos(
                    self._path_to_videos, strict=self.strict_probe
                )
                with open(valid_file, "wb") as h:
                    pickle.dump(
                        self.valid_indices, h, protocol=pickle.HIGHEST_PROTOCOL
                    )
            if self.num_data_samples is not None:
                self.valid_indices = self.valid_indices[
                    : self.num_data_samples
                ]
        elif self.ds_name == "ucf101":
            ann = self.annotation_path or os.path.join(
                os.path.dirname(self.data_prefix), "ucfTrainTestlist"
            )
            self.valid_indices = select_fold_ucf101(
                self.data_prefix,
                self._path_to_videos,
                ann,
                self.fold,
                self.mode == "train",
            )
        elif self.ds_name == "hmdb51":
            ann = self.annotation_path or os.path.join(
                os.path.dirname(self.data_prefix), "splits"
            )
            self.valid_indices = select_fold_hmdb51(
                self._path_to_videos, ann, self.fold, self.mode == "train"
            )
        else:
            self.valid_indices = list(range(len(self._path_to_videos)))
        logger.info(
            "%s/%s: %d videos, %d valid",
            self.ds_name,
            self.mode,
            len(self._path_to_videos),
            len(self.valid_indices),
        )

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.valid_indices)

    @property
    def labels(self) -> np.ndarray:
        return np.asarray(self._labels)[np.asarray(self.valid_indices)]

    def get_example(self, index: int, rng: Optional[np.random.Generator] = None):
        """Decode-failure tolerant fetch: a corrupt/truncated file must not
        kill a 200-epoch run (the reference wraps decode in try/except and
        returns None, dropped by collate — decoder.py:347-384,
        retrieval_utils.py:22-27). Batches are fixed-shape, so instead
        of dropping we log and resample another valid index, bounded by
        ``decode_retries``."""
        if rng is None:
            rng = np.random.default_rng()
        last_err = None
        for attempt in range(self.decode_retries + 1):
            try:
                return self._get_example_once(index, rng)
            except (RuntimeError, OSError, ValueError) as e:
                last_err = e
                logger.warning(
                    "decode failed for sample %d (%s); resampling "
                    "(attempt %d/%d)",
                    index, e, attempt + 1, self.decode_retries,
                )
                index = int(rng.integers(len(self)))
        raise RuntimeError(
            f"{self.decode_retries + 1} consecutive decode failures; "
            f"last: {last_err}"
        )

    def _get_example_once(
        self, index: int, rng: np.random.Generator
    ):
        index_capped = index
        index = self.valid_indices[index_capped]

        if self.mode in ("train", "val"):
            temporal_sample_index = -1
            spatial_sample_index = -1
            min_scale, max_scale = self.train_jitter_scales
            crop_size = self.train_crop_size
            if self.center_crop:
                spatial_sample_index = 1
                min_scale = max_scale = crop_size = self.train_crop_size
        else:
            temporal_sample_index = (
                self._spatial_temporal_idx[index] // self.num_spatial_crops
            )
            spatial_sample_index = (
                self._spatial_temporal_idx[index] % self.num_spatial_crops
            )
            min_scale = max_scale = crop_size = self.test_crop_size

        num_clips = 2 if self.mode in ("train", "val") and self.dual_data else 1
        vids, specs = [], []
        for _ in range(num_clips):
            frames, spec = self._decode_one(
                index,
                temporal_sample_index if self.temp_jitter else 500,
                self.num_ensemble_views if self.temp_jitter else 1000,
                rng,
            )
            frames = spatial_sampling(
                frames,
                spatial_idx=spatial_sample_index,
                min_scale=min_scale,
                max_scale=max_scale,
                crop_size=crop_size,
                rng=rng,
            )
            vids.append(frames)
            if spec is not None:
                specs.append(spec)

        video = np.concatenate(vids, axis=0)
        out = {
            "video": video,
            "label": self._labels[index],
            "index": index_capped,
            "vid_idx": self._vid_indices[index],
        }
        if self.decode_audio and specs:
            if self.return_pcm:
                # single clip: [S]; dual_data: [2, S] — the device frontend
                # turns clip rows into spectrogram channels, matching the
                # reference's channel-stacked dual specs
                # (AVideoDataset.py:451)
                pcm = [np.atleast_1d(s).astype(np.float32) for s in specs]
                out["audio_pcm"] = (
                    pcm[0] if num_clips == 1 else np.stack(pcm)
                )
            elif num_clips == 1:
                out["audio"] = specs[0][0]  # [F, T]
            else:
                # dual_data: the reference concatenates the two [1,F,T]
                # specs along the channel axis (AVideoDataset.py:451)
                out["audio"] = np.stack(
                    [s[0] for s in specs], axis=-1
                )  # [F, T, 2]
        return out

    def _decode_one(self, index, clip_idx, num_clips, rng):
        path = self._path_to_videos[index]
        frames, fps, start_sec = dec.decode_video(
            path,
            self.sample_rate,
            self.num_frames,
            clip_idx,
            num_clips,
            target_fps=self.target_fps,
            rng=rng,
        )
        if frames is None:
            raise RuntimeError(f"failed to decode {path}")
        spec = None
        if self.decode_audio:
            wav = dec.decode_audio(path, self.aud_sample_rate)
            if wav is None:
                raise RuntimeError(f"failed to decode audio of {path}")
            if self.return_pcm:
                # device-spectrogram path: the host only slices and jitters
                # the waveform; the card computes the spectrogram
                spec = slice_clip_pcm(
                    wav,
                    start_sec,
                    num_sec=self.num_sec,
                    sample_rate=self.aud_sample_rate,
                    use_volume_jittering=self.use_volume_jittering,
                    use_temporal_jittering=self.use_temporal_jittering,
                    rng=rng,
                )
            else:
                spec = get_spec(
                    wav,
                    start_sec,
                    num_sec=self.num_sec,
                    sample_rate=self.aud_sample_rate,
                    aud_spec_type=self.aud_spec_type,
                    use_volume_jittering=self.use_volume_jittering,
                    use_temporal_jittering=self.use_temporal_jittering,
                    z_normalize=self.z_normalize,
                    rng=rng,
                )
        return frames, spec
