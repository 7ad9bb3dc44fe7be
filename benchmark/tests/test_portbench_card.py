"""On the card: a tiny self-labeling run through the fused SK kernel, held
to the reference. Skips where there is no card (decided in the fixture)."""

import pytest

from benchmark.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.card
def test_selflabel_on_the_card(card, tmp_path):
    from benchmark import harness

    cfg = dict(harness.load_cell(harness.spec(), "vggsound-selflabel")[1],
               **tiny.TINY)
    wl = dict(harness.load_cell(harness.spec(), "vggsound-selflabel")[2])
    wl["limits"] = {"label_gap": 1.0, "cost_gap": 1e-3}
    r = harness.Run(cell="vggsound-selflabel", seed=5, seconds=1.0,
                    trace=True, config=cfg, workload=wl, device=card,
                    cache=tmp_path)
    import time

    r.t0 = time.perf_counter()
    harness.driver(wl).run(r)
    assert r.correct, r.checks
    assert r.summary is not None and r.summary["busy_s"] > 0
