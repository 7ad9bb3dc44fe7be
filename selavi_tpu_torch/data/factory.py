"""Dataset construction shared by the CLIs (``selavi_tpu/data/factory.py``).

One factory covers the synthetic set, packed shards (``data/packed.py``)
and the real-media datasets (``data/dataset.py``: kinetics, vggsound,
kinetics_sound, ave, ucf101, hmdb51 and any ``folder`` tree), so every CLI
accepts the JAX package's ``--ds_name`` surface, including the PCM
(``--device_spectrogram``) path. ``eval_mode=True`` reproduces the
reference's evaluation dataset: center crop, no temporal jitter
(get_clusters.py:294-312).
"""

from __future__ import annotations


def build_dataset(args, mode: str = "train", eval_mode: bool = False):
    return_pcm = bool(getattr(args, "device_spectrogram", False))
    if args.ds_name == "packed":
        from selavi_tpu_torch.data.packed import PackedAVDataset

        return PackedAVDataset(
            args.root_dir,
            crop_size=args.train_crop_size,
            mode="val" if eval_mode else mode,
            num_sec=args.num_sec_aud,
            sample_rate=args.aud_sample_rate,
        )
    if args.ds_name == "synthetic":
        from selavi_tpu_torch.data.synthetic import SyntheticAVDataset

        return SyntheticAVDataset(
            num_samples=args.num_data_samples or 64,
            num_classes=max((getattr(args, "mlp_dim", None) or 8) // 4, 2),
            num_frames=args.num_frames,
            crop_size=args.train_crop_size,
            num_sec=args.num_sec_aud,
            aud_sample_rate=args.aud_sample_rate,
            aud_spec_type=args.aud_spec_type,
            z_normalize=args.z_normalize,
            seed=getattr(args, "seed", 31),
            return_pcm=return_pcm,
        )
    from selavi_tpu_torch.data.dataset import AVideoDataset

    kwargs = dict(
        ds_name=args.ds_name,
        root_dir=args.root_dir,
        mode=mode,
        path_to_data_dir=args.data_path,
        num_frames=args.num_frames,
        target_fps=args.target_fps,
        train_crop_size=args.train_crop_size,
        num_data_samples=args.num_data_samples,
        num_sec=args.num_sec_aud,
        aud_sample_rate=args.aud_sample_rate,
        aud_spec_type=args.aud_spec_type,
        z_normalize=args.z_normalize,
        seed=getattr(args, "seed", 31),
        return_pcm=return_pcm,
        strict_probe=getattr(args, "strict_probe", False),
    )
    if eval_mode:
        kwargs.update(center_crop=True, temp_jitter=False)
    else:
        kwargs.update(
            sample_rate=getattr(args, "sample_rate", 1),
            test_crop_size=getattr(args, "test_crop_size", 112),
            use_volume_jittering=getattr(args, "use_volume_jittering", False),
            use_temporal_jittering=getattr(
                args, "use_audio_temp_jittering", False),
            dual_data=getattr(args, "dual_data", False),
        )
    return AVideoDataset(**kwargs)


def add_dataset_flags(parser):
    """The dataset-construction flag surface shared by the eval CLIs. The
    parser must have the 'bool' string type registered
    (``selavi_tpu_torch.config.bool_flag``). Defaults match the reference
    opt.py; --mlp_dim must match training for synthetic datasets (it
    derives the synthetic class count)."""
    parser.add_argument("--ds_name", type=str, default="vggsound")
    parser.add_argument("--root_dir", type=str, default="/path/to/dataset")
    parser.add_argument("--data_path", type=str, default="datasets/data")
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--num_frames", type=int, default=30)
    parser.add_argument("--target_fps", type=int, default=30)
    parser.add_argument("--train_crop_size", type=int, default=112)
    parser.add_argument("--num_sec_aud", type=int, default=1)
    parser.add_argument("--aud_sample_rate", type=int, default=48000)
    parser.add_argument("--aud_spec_type", type=int, default=2)
    parser.add_argument("--z_normalize", type="bool", default="True")
    parser.add_argument("--mlp_dim", type=int, default=None)
    parser.add_argument("--num_data_samples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=31,
                        help="dataset seed; must match training for "
                             "synthetic ground-truth label consistency")
    parser.add_argument("--device_spectrogram", type="bool",
                        default="False",
                        help="dataset ships raw PCM; spectrograms are "
                             "computed on the card (matches training with "
                             "--device_spectrogram)")
    return parser


def audio_cfg_from_args(args) -> dict:
    """The card's audio-frontend config (``ops/logmel.py``) matching the
    host frontend flags (reference audio_utils.py:46-72)."""
    return {
        "samplerate": args.aud_sample_rate,
        "nfilt": 40 if args.aud_spec_type == 1 else 257,
        "z_normalize": args.z_normalize,
    }
