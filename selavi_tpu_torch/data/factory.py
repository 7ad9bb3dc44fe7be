"""Dataset construction (``selavi_tpu/data/factory.py::build_dataset``).

The port has only the synthetic set so far; ``packed`` shards and the
real-media datasets raise until ROADMAP Queue 1 item 2 ports them.
"""

from __future__ import annotations

DATASETS_ITEM = "2 (datasets: the factory, packed shards and real media)"


def build_dataset(args):
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
        )
    raise NotImplementedError(
        f"--ds_name {args.ds_name!r} is not ported yet (only 'synthetic'); "
        f"it is ROADMAP Queue 1 item {DATASETS_ITEM}")
