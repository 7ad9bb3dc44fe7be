"""The port's eval CLIs on 2 ranks against 1, on the CPU
(``tests/_torch_dist.py`` spawns the ranks), as the JAX package's
``tests/test_multiprocess.py::test_two_process_eval_tools`` holds its own:
``cli.get_clusters`` (its pickle to atol 2e-4, rtol 1e-4),
``cli.video_retrieval`` (v-v) and ``cli.finetune_video --test_only`` (the
results equal). The sample counts are odd, so every split ends in a rank's
wrap-padding, which the gathers must drop. The finetune train step under
DDP on 2 ranks equals the 1-rank step at twice the batch, its flips and
dropout mask drawn for the global batch and its final BatchNorm global.
"""

import pickle
import shutil

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, finetune_step
from _torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Rank outputs and dumps of the 1-rank run (no process group) and the
    2-rank run, which run at the same time."""
    runs = {world: (tmp_path_factory.mktemp(f"eval{world}"),)
            for world in (1, 2)}
    started = {world: Ranks("eval", world, tmp) for world, (tmp,) in
               runs.items()}
    out = {}
    for world, ranks in started.items():
        tmp = runs[world][0]
        results = ranks.results(timeout=150)
        with open(tmp / "ps.pkl", "rb") as f:
            out[world] = (results, pickle.load(f))
    yield out
    for tmp, in runs.values():
        shutil.rmtree(tmp, ignore_errors=True)


def test_get_clusters_two_ranks_equal_one(eval_runs):
    (_, one), (_, two) = eval_runs[1], eval_runs[2]
    np.testing.assert_array_equal(np.asarray(one[1]), np.asarray(two[1]))
    assert len(one[0]) == len(two[0]) == 2
    for head_a, head_b in zip(one[0] + one[2], two[0] + two[2]):
        assert tuple(head_a.shape) == (23, 8)
        np.testing.assert_allclose(np.asarray(head_a), np.asarray(head_b),
                                   atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("tool", ["retrieval", "finetune"])
def test_tool_two_ranks_equal_one(eval_runs, tool):
    (one, _), (two, _) = eval_runs[1], eval_runs[2]
    assert two[0][tool] == two[1][tool]  # every rank returns the result
    assert one[0][tool] == two[0][tool]


def test_finetune_step_two_ranks_equal_one_at_twice_the_batch(tmp_path):
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "ft_inputs.npz",
             video=rng.integers(0, 256, (4, 4, 32, 32, 3), np.uint8),
             labels=np.array([0, 3, 1, 3]))
    started = Ranks("ft_step", 2, tmp_path)
    ref = finetune_step(0, 1, str(tmp_path))
    ranks = started.results(timeout=90)
    # fp64, the sums split over the ranks: 1e-9 of scale
    np.testing.assert_allclose((ranks[0]["loss"] + ranks[1]["loss"]) / 2,
                               ref["loss"], rtol=1e-9)
    before = ref["before"]
    for name, value in ref["state"].items():
        got = ranks[0]["state"][name]
        assert torch.equal(got, ranks[1]["state"][name]), name
        if "running" not in name:  # the update
            got, value = got - before[name], value - before[name]
        scale = max(float(value.abs().max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), value.numpy(), rtol=0,
                                   atol=1e-9 * scale, err_msg=name)
