"""The shard, the mod-N dataset wrapper, and the reference's reading of
both against the system's."""

import numpy as np
import pytest

from benchmark import data
from benchmark.reference import inputs


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    cfg = dict(mlp_dim=16, distinct_samples=5, num_frames=3, stored_size=24,
               aud_sample_rate=8000, num_sec_aud=1, data_seed=7)
    path = data.shard_path(cfg, d)
    yield path
    path.unlink()


def test_mod_n_serves_record_i_mod_r_under_index_i(shard):
    from selavi_tpu_torch.data.packed import PackedAVDataset

    inner = PackedAVDataset(str(shard), crop_size=16, num_sec=1,
                            sample_rate=8000)
    ds = data.ModN(inner, 12)
    assert len(ds) == 12
    assert np.array_equal(ds.labels, np.tile(inner.labels, 3)[:12])
    a = ds.get_example(7, np.random.default_rng(3))
    b = inner.get_example(2, np.random.default_rng(3))
    assert a["index"] == a["vid_idx"] == 7 and b["index"] == 2
    assert np.array_equal(a["video_y"], b["video_y"])
    assert np.array_equal(a["audio_pcm"], b["audio_pcm"])
    inner.close()


def test_the_reference_reads_what_the_loader_serves(shard):
    """The reference's order, crops and decode equal the system's loader
    and its wire decode, bit for bit."""
    import torch

    from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batch
    from selavi_tpu_torch.data.packed import PackedAVDataset

    inner = PackedAVDataset(str(shard), crop_size=16, num_sec=1,
                            sample_rate=8000)
    ds = data.ModN(inner, 12)
    loader = DataLoader(ds, batch_size=4, shuffle=True, seed=99,
                        num_workers=2)
    loader.set_epoch(0)
    got = [decode_wire_batch(b) for b, _ in zip(loader, range(2))]
    ref = inputs.Shard(shard)
    order = inputs.epoch_order(12, 99)
    for k, batch in enumerate(got):
        idx = order[4 * k:4 * k + 4]
        assert np.array_equal(batch["index"].numpy(), idx)
        y, uv, pcm = inputs.read_batch(ref, idx, 16, 99)
        rgb = inputs.yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(uv))
        assert torch.equal(rgb, batch["video"])
        assert np.array_equal(pcm.astype(np.float32),
                              batch["audio_pcm"].numpy())
    inner.close()


def test_the_shard_is_built_once(shard):
    stamp = shard.stat().st_mtime_ns
    cfg = dict(mlp_dim=16, distinct_samples=5, num_frames=3, stored_size=24,
               aud_sample_rate=8000, num_sec_aud=1, data_seed=7)
    assert data.shard_path(cfg, shard.parent) == shard
    assert shard.stat().st_mtime_ns == stamp
    assert inputs.Shard(shard).n == 5
