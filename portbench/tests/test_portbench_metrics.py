"""The metric arithmetic: rates, percentiles, spreads, the idle union, the
gap labels and each per-layer reader on a synthetic profiler summary."""

import numpy as np
import pytest

from harness import roofline, stats, trace
from harness.spans import Spans
from harness.spec import metric_reader

MS = 1_000_000  # ns


def test_rate_over_the_window():
    assert stats.rate(300, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    v = rng.gamma(2.0, 50.0, 333).tolist()
    for q in (50, 95, 99):
        assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q), rel=1e-12)
    assert stats.percentile([7.0], 95) == 7.0


def _spans():
    s = Spans()
    s.items = [("source", 0, 1 * MS), ("batch_call", 1 * MS, 9 * MS),
               ("sink", 9 * MS, 10 * MS), ("collect", 4 * MS, 5 * MS + MS // 2)]
    return s


def _summary():
    # device: H2D 2-4 ms, a kernel 3-5 ms (overlaps), D2H 7-8 ms; window 0-10 ms
    dev = [("Memcpy HtoD (Pinned -> Device)", 2 * MS, 4 * MS),
           ("mark_tile_kernel", 3 * MS, 5 * MS),
           ("Memcpy DtoH (Device -> Pinned)", 7 * MS, 8 * MS),
           ("late_kernel", 12 * MS, 13 * MS)]  # outside the window: ignored
    return trace.summarize("mark", dev, _spans(), 0, 10 * MS,
                           {"batches": 2, "codec_bytes": int(3.35e12 * 0.0015)})


def test_idle_union_and_device_split():
    s = _summary()
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.004)  # [2, 5] and [7, 8]
    assert s.htod_s == pytest.approx(0.002)
    assert s.dtoh_s == pytest.approx(0.001)
    assert s.noncopy_s == pytest.approx(0.002)
    assert "late_kernel" not in s.device_ops


def test_gaps_take_the_label_of_the_innermost_open_span():
    s = _summary()
    # gaps: [0, 2] (mid 1: batch_call starts at 1), [5, 7] (mid 6: collect
    # ended at 5.5, batch_call open), [8, 10] (mid 9: sink)
    assert set(s.idle) == {"batch_call", "sink"}
    assert s.idle["batch_call"][0] == pytest.approx(0.004)
    assert s.idle["batch_call"][1] == 2
    assert s.idle["sink"][0] == pytest.approx(0.002)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "Memcpy HtoD (Pinned -> Device)"
    assert len(b["idle_gaps"]) == 2 and b["idle_gaps"][0][0].startswith("batch_call")


def test_per_layer_readers():
    s = _summary()
    assert metric_reader("batch_call_ms.mark")(s) == pytest.approx((8 + 1.5) / 2)
    assert metric_reader("copy_engine_ms.mark")(s) == pytest.approx(1.5)
    # least time 1.5 ms over 2 ms of non-copy device time
    assert metric_reader("codec_roofline.mark")(s) == pytest.approx(75.0)
    assert metric_reader("device_idle_share.mark")(s) == pytest.approx(60.0)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    empty = trace.summarize("mark", [], Spans(), 0, 10 * MS, {"batches": 2, "codec_bytes": 0})
    for name in ("batch_call_ms.mark", "copy_engine_ms.mark", "codec_roofline.mark",
                 "device_idle_share.mark"):
        assert metric_reader(name)(empty) is None
    # a detect metric reads nothing in a mark cell
    assert metric_reader("device_idle_share.detect")(_summary()) is None


def test_segment_p95_comes_from_the_drivers_latencies():
    s = trace.summarize("mark", [], Spans(), 0, 10 * MS, {}, {"segment_p95_ms": 123.5})
    assert metric_reader("segment_p95_ms")(s) == 123.5
    assert metric_reader("segment_p95_ms")(_summary()) is None


def test_least_bytes_of_the_codec_calls():
    # a 1080p batch of 16: a mark reads and writes 99.5 MB each way
    assert roofline.mark_bytes(16, 1080, 1920) == 2 * 16 * 1080 * 1920 * 3
    assert roofline.mark_bytes(12, 1080, 1920, 3) == 4 * 12 * 1080 * 1920 * 3
    assert roofline.extract_bytes(16, 1080, 1920, 8) == 16 * (1080 * 1920 * 3 + 8)
    assert roofline.least_seconds(int(3.35e12)) == pytest.approx(1.0)
