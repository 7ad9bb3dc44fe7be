"""Pack a dataset into a pre-decoded shard: decode once, train many epochs
(the port's ``scripts/pack_dataset.py``).

    python -m selavi_tpu_torch.cli.pack_dataset --ds_name synthetic \
        --num_data_samples 256 --train_crop_size 160 --output x.pack \
        --pack_video_format yuv420 --pack_pcm_dtype int16

The dataset is built by ``data/factory.py`` with the PCM path forced on, so
the shard carries raw waveforms. Store the video at the top of the
scale-jitter range (``--train_crop_size 160`` for 112-crop training), so
``PackedAVDataset`` can random-crop it each epoch; then train with
``--ds_name packed --root_dir x.pack --train_crop_size 112``. The shard's
bytes are those of the JAX package's script for the same dataset.
"""

from __future__ import annotations

from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data.factory import build_dataset
from selavi_tpu_torch.data.packed import write_packed_shard


def main(argv=None) -> dict:
    parser = parse_arguments()
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--pack_video_format", type=str, default="rgb",
                        choices=["rgb", "yuv420"],
                        help="yuv420 halves the video bytes on the wire (RGB "
                             "is rebuilt on the card)")
    parser.add_argument("--pack_pcm_dtype", type=str, default="int16",
                        choices=["int16", "float32"],
                        help="int16 = native decode width, half the fp32 "
                             "audio bytes")
    args = parser.parse_args(argv)
    args.device_spectrogram = True  # the shard carries raw waveforms
    meta = write_packed_shard(
        build_dataset(args), args.output, num_samples=args.num_data_samples,
        seed=args.seed, video_format=args.pack_video_format,
        pcm_dtype=args.pack_pcm_dtype,
    )
    print(f"packed {meta['n']} samples -> {args.output} "
          f"(video {meta['video_shape']} {args.pack_video_format}, "
          f"pcm {meta['pcm_len']} {args.pack_pcm_dtype})")
    return meta


if __name__ == "__main__":
    main()
