"""The readers of the program's spans (``benchmark/spans.py``): what they
read from the totals and counters that the program kept while the
``Tracer`` recorded, and None wherever a run holds nothing of them."""

import pytest

from benchmark import harness
from selavi_tpu_torch.utils import profiling

TRAIN = ["trainer.data_wait_pct", "loader.wait_ms", "loader.collate_ms"]
SK = ["engine.loader_start_s"]
# as a traced pretraining run of three steps leaves them: the waits in
# which the profiler started and stopped are not recorded
TRAIN_TOTALS = {"trainer.data": [2, 0.08], "trainer.step": [3, 2.1],
                "loader.wait": [3, 0.003], "loader.collate": [3, 0.24],
                "loader.decode": [3, 0.0006]}
SK_TOTALS = {"engine.aggregate": [2, 10.5],
             "engine.loader_start": [2, 0.41], "engine.data": [32, 0.02]}


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


def recorded(totals, counters=None):
    profiling.totals.update({k: list(v) for k, v in totals.items()})
    profiling.counters.update(counters or {})


def traced_run(driver, summary=True, steps=3, wall=2.4):
    r = harness.Run(cell="x", seed=1, seconds=1.0, trace=True, config={},
                    workload={"driver": driver}, device="cpu")
    r.summary = {"busy_s": 2.3, "window_s": wall} if summary else None
    r.traced_steps, r.traced_wall_s = steps, wall
    return r


def test_the_train_span_readers():
    recorded(TRAIN_TOTALS, {"loader.batches": 3})
    r = traced_run("pretrain")
    got = {name: harness.reader(name)(r) for name in TRAIN}
    assert got == {
        # the mean wait (40 ms) times three steps over 2.4 s of wall
        "trainer.data_wait_pct": pytest.approx(5.0),
        "loader.wait_ms": pytest.approx(1.0),
        "loader.collate_ms": pytest.approx(80.0)}
    # every span's count and seconds, printed as a reading
    assert r.extra["spans.totals"] == TRAIN_TOTALS
    assert r.extra["spans.counters"] == {"loader.batches": 3}


def test_the_sk_span_reader():
    recorded(SK_TOTALS)
    r = traced_run("selflabel", steps=1)
    assert harness.reader("engine.loader_start_s")(r) == pytest.approx(0.41)


@pytest.mark.parametrize("name", TRAIN + SK)
def test_every_span_reader_reads_nothing_without_its_spans(name,
                                                           monkeypatch):
    read = harness.reader(name)
    right, wrong = (("pretrain", "selflabel") if name in TRAIN
                    else ("selflabel", "pretrain"))
    recorded({**TRAIN_TOTALS, **SK_TOTALS}, {"loader.batches": 3})
    assert read(traced_run(right)) is not None
    assert read(traced_run(wrong)) is None
    assert read(traced_run(right, summary=False)) is None  # no trace
    profiling.reset()  # a program that recorded no spans
    assert read(traced_run(right)) is None
    # a program without the span layer
    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "counters")
    assert read(traced_run(right)) is None


def test_a_batch_count_of_zero_reads_nothing():
    recorded(TRAIN_TOTALS)
    r = traced_run("pretrain")
    assert harness.reader("loader.wait_ms")(r) is None
    assert harness.reader("loader.collate_ms")(r) is None
    assert harness.reader("trainer.data_wait_pct")(r) == pytest.approx(5.0)
