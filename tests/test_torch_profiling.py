"""The port's span layer (``selavi_tpu_torch/utils/profiling.py``) on the
CPU: a span times its block always and records into a ``torch.profiler``
trace, ``totals`` and ``counters`` only while a profiler records, and
into ``totals`` only where it records to the span's end; the
Trainer's epoch and the SK engine's step put their spans where the work
happens, and the engine's ``timings`` keep their keys."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data.synthetic import SyntheticAVDataset
from selavi_tpu_torch.selflabel import engine
from selavi_tpu_torch.selflabel.engine import SKConfig, cluster
from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.train.loop import Trainer
from selavi_tpu_torch.utils import profiling
from selavi_tpu_torch.utils.profiling import count, span, trace_window

torch.set_num_threads(1)

TINY = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 1 --batch_size 4 --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1 --nopts 1 "
    "--bn_warmup_batches 0 --compute_dtype float32 --sk_agg_batch 8 "
    "--base_lr 0.01 --wd 0.00001"
)
TRAIN_SPANS = {"trainer.data", "trainer.step", "loader.wait",
               "loader.collate", "loader.decode", "train.input",
               "train.forward", "train.backward", "train.optimizer"}


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset()
    yield
    profiling.reset()


def _annotations(prof, tmp_path):
    """The trace's ``user_annotation`` events of ``prof``."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_a_span_outside_a_profiler_times_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with span("outside") as s:
        sum(range(1000))
    count("outside.count", 3)
    assert s.seconds > 0
    assert profiling.totals == {} and profiling.counters == {}


def test_nested_spans_land_in_the_trace_with_their_nesting(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer") as outer:
            with span("inner"):
                torch.ones(64, 64).sum()
            with span("inner"):
                torch.ones(8).sum()
            count("things", 2)
        count("things")
    assert profiling.totals["outer"][0] == 1
    assert profiling.totals["outer"][1] == pytest.approx(outer.seconds)
    assert profiling.totals["inner"][0] == 2
    assert profiling.totals["inner"][1] <= outer.seconds
    assert profiling.counters == {"things": 3}
    events = {}
    for e in _annotations(prof, tmp_path):
        events.setdefault(e["name"], []).append(e)
    (o,) = events["outer"]
    assert len(events["inner"]) == 2
    for i in events["inner"]:  # on the parent's thread, inside it
        assert i["tid"] == o["tid"]
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    profiling.reset()
    assert profiling.totals == {} and profiling.counters == {}


def test_spans_record_under_trace_window(tmp_path):
    with trace_window(str(tmp_path)):
        with span("in.window"):
            torch.ones(4).sum()
    events = json.loads((tmp_path / "profile" / profiling.TRACE_NAME)
                        .read_text())["traceEvents"]
    assert [e["name"] for e in events
            if e.get("cat") == "user_annotation"] == ["in.window"]
    assert profiling.totals["in.window"][0] == 1


@pytest.mark.parametrize("workers", [0, 2])
def test_a_train_epoch_records_every_train_span(workers, tmp_path):
    args = parse_arguments().parse_args(
        TINY.split() + ["--workers", str(workers)])
    dataset = SyntheticAVDataset(
        num_samples=args.num_data_samples, num_classes=4,
        num_frames=args.num_frames, crop_size=args.train_crop_size,
        aud_sample_rate=args.aud_sample_rate,
        aud_spec_type=args.aud_spec_type, seed=args.seed)
    trainer = Trainer(args, dataset, device="cpu")
    trainer.sk_schedule = [float("inf")]  # no SK step in the epoch
    steps = trainer.batches_per_epoch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(0)
    totals = profiling.totals
    assert TRAIN_SPANS <= set(totals)
    for name in TRAIN_SPANS - {"trainer.data"}:
        assert totals[name][0] == steps, name
    # one wait more than steps: the one that finds the epoch's end
    assert totals["trainer.data"][0] == steps + 1
    assert profiling.counters == {"loader.batches": steps}
    assert not any(name.startswith("engine.") for name in totals)
    events = _annotations(prof, tmp_path)
    # trainer.data is timed and totalled but kept out of the trace
    names = {e["name"] for e in events if e["name"] in totals}
    assert names == TRAIN_SPANS - {"trainer.data"}
    # each train.* span inside a trainer.step, loader.* between them
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == "trainer.step"]
    for e in events:
        inside = any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                     for a, b in steps)
        layer = e["name"].split(".")[0]
        if layer in ("train", "loader"):
            assert inside == (layer == "train"), e["name"]


class StoppingLoader:
    """A caller's wrapper of the Trainer's loader that starts a profiler
    before batch ``start`` and stops it before batch ``stop``, inside the
    Trainer's wait for that batch."""

    def __init__(self, loader, prof, start, stop):
        self.loader, self.prof = loader, prof
        self.start, self.stop = start, stop
        self.batch_size = loader.batch_size

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def close(self):
        self.loader.close()

    def __iter__(self):
        for k, batch in enumerate(self.loader):
            if k == self.start:
                self.prof.start()
            elif k == self.stop:
                self.prof.stop()
            yield batch


def test_a_profiler_stopped_inside_the_data_wait_cuts_no_span(tmp_path):
    args = parse_arguments().parse_args(TINY.split() + ["--workers", "0"])
    dataset = SyntheticAVDataset(
        num_samples=args.num_data_samples, num_classes=4,
        num_frames=args.num_frames, crop_size=args.train_crop_size,
        aud_sample_rate=args.aud_sample_rate,
        aud_spec_type=args.aud_spec_type, seed=args.seed)
    trainer = Trainer(args, dataset, device="cpu")
    trainer.sk_schedule = [float("inf")]
    prof = profile(activities=[ProfilerActivity.CPU])
    # the batches are fetched before the wrapper's call: batches 1 and 2
    # are collated, waited for and stepped under the profiler, and the
    # wait for batch 2 alone both begins and ends under it
    trainer.loader = StoppingLoader(trainer.loader, prof, 1, 3)
    trainer.train_epoch(0)
    totals = profiling.totals
    assert totals["trainer.data"][0] == 1
    assert totals["trainer.step"][0] == 2
    assert profiling.counters == {"loader.batches": 2}
    events = _annotations(prof, tmp_path)
    assert events and all(e.get("args", {}).get("finished", True)
                          for e in events)


@pytest.mark.parametrize("annotate", [True, False])
def test_a_span_cut_short_by_a_stop_stays_out_of_totals(annotate, tmp_path):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with span("whole"):
        torch.ones(4).sum()
    with span("cut", annotate=annotate) as cut:
        prof.stop()
    assert cut.seconds > 0
    assert set(profiling.totals) == {"whole"}
    events = {e["name"]: e for e in _annotations(prof, tmp_path)}
    # an annotation the stop cut short is marked so in the trace
    assert set(events) == ({"whole", "cut"} if annotate else {"whole"})
    if annotate:
        assert events["cut"]["args"]["finished"] is False


def _batches(fv, fa, bs=16):
    for s in range(0, len(fv), bs):
        idx = np.arange(s, min(s + bs, len(fv)))
        yield {"video": torch.from_numpy(fv[idx]),
               "audio": torch.from_numpy(fa[idx]), "index": idx}


@pytest.mark.parametrize("ind_groups,cache", [(1, False), (2, False),
                                              (2, True)])
def test_an_sk_step_records_a_loader_start_a_pass(ind_groups, cache):
    n, k, h, d = 64, 6, 2, 32
    rng = np.random.default_rng(0)
    fv = rng.standard_normal((n, d)).astype(np.float32)
    fa = rng.standard_normal((n, d)).astype(np.float32)
    wv = (rng.standard_normal((h, d, k)) * 0.05).astype(np.float32)
    wa = (rng.standard_normal((h, d, k)) * 0.05).astype(np.float32)
    cfg = SKConfig(headcount=h, num_clusters=k, ind_groups=ind_groups,
                   match=False, distribution="gauss", sk_backend="plain",
                   cache_group_batches=cache)
    with profile(activities=[ProfilerActivity.CPU]):
        cluster(
            encode_fn=lambda v, a: (v, a),
            head_logits_fn=lambda f, m: torch.einsum(
                "nd,hdk->hnk", f, torch.from_numpy(wv if m == "v" else wa)),
            make_batch_iter=lambda: _batches(fv, fa),
            n=n, cfg=cfg, selflabels=np.zeros((n, h), np.int32),
            marginal_state=MarginalState(), iter_num=1,
            np_rng=np.random.default_rng(7), device="cpu")
    totals = profiling.totals
    assert totals["engine.loader_start"][0] == ind_groups
    assert totals["engine.aggregate"][0] == ind_groups
    # the 3 later batches of 4 and the wait that ends the pass
    assert totals["engine.data"][0] == 4 * ind_groups
    assert totals["engine.solve"][0] == h
    assert set(engine.timings) == {"aggregate_s", "match_s", "solve_s"}
    assert engine.timings["aggregate_s"] == pytest.approx(
        totals["engine.aggregate"][1])
    assert engine.timings["solve_s"] == pytest.approx(
        totals["engine.solve"][1])
