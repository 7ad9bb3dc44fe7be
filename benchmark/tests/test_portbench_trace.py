"""The idle/busy and top-ops arithmetic on a hand-made Chrome trace."""

import pytest

from benchmark import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summary_of_a_hand_made_trace():
    events = [
        ev("cpu_op", "aten::conv", 0, 100),
        ev("cpu_op", "aten::copy_", 40, 10),
        ev("kernel", "conv_fprop", 10, 20),      # 10..30
        ev("kernel", "relu", 25, 15),            # 25..40, overlaps
        ev("gpu_memcpy", "Memcpy HtoD", 60, 10),  # 60..70
        ev("kernel", "conv_fprop", 90, 5),       # 90..95
        ev("cpu_op", "aten::sum", 96, 4),
        {"ph": "i", "name": "marker", "ts": 500},  # no duration: ignored
    ]
    s = trace.summarize(events)
    # union of device intervals: 10..40, 60..70, 90..95 = 45 us
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["device_by_name"]["conv_fprop"] == [2, pytest.approx(25e-6)]
    assert [n for n, _ in s["device_ops"]] == ["conv_fprop", "relu",
                                               "Memcpy HtoD"]
    # gaps, longest first (ties in time order): 40..60 (its midpoint 50
    # under aten::copy_ 40..50, the innermost), 70..90, 0..10 (under
    # aten::conv), 95..100 (under aten::sum)
    assert s["idle_gaps"] == [
        ["aten::copy_", pytest.approx(20e-6)],
        ["aten::conv", pytest.approx(20e-6)],
        ["aten::conv", pytest.approx(10e-6)],
        ["aten::sum", pytest.approx(5e-6)]]
    assert trace.mean_duration(s, "conv") == pytest.approx(12.5e-6)
    assert trace.mean_duration(s, "absent") is None


def test_a_gap_under_no_host_op_names_the_op_before_it():
    events = [
        {"ph": "X", "cat": "python_function", "name": "PyTorch Profiler (0)",
         "ts": 0, "dur": 100},
        ev("cpu_op", "aten::conv", 0, 10),
        ev("kernel", "conv_fprop", 5, 10),        # 5..15
        ev("cpu_op", "aten::item", 20, 5),
        ev("kernel", "relu", 60, 40),             # 60..100
    ]
    s = trace.summarize(events)
    # gaps 15..60 (midpoint 37.5: no op spans it; aten::item began last)
    # and 0..5 (under aten::conv)
    assert s["idle_gaps"] == [["after aten::item", pytest.approx(45e-6)],
                              ["aten::conv", pytest.approx(5e-6)]]


def test_a_trace_without_device_work_reads_nothing():
    assert trace.summarize([ev("cpu_op", "aten::add", 0, 5)]) is None


def test_union_merges_overlaps():
    assert trace.union([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
