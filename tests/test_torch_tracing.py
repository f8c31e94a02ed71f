"""The port's span recorder (``utils/profiling.py``) on the batch path, on
the CPU: nothing recorded while it is off; the names, parents, batch ids
and items of the spans of ``FrameMarker.mark``, of a ``MultiMarker``
submit and collect on two threads and of ``FrameExtractor.extract``
(``DtcwtKey``, 64x96); self times; ``Embedder``'s ``stage_seconds`` as the
sums of its spans; and ``cli mark --profile``'s span table and trace.
The waits on a card (``sync.*``) are held by ``tests/test_torch_cuda.py``;
here a handle's wait is driven by a stand-in event.
"""

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoWriter
from vfp_tpu_torch.pipeline import Embedder, FrameExtractor, FrameMarker, MultiMarker
from vfp_tpu_torch.utils import profiling
from vfp_tpu_torch.utils.profiling import Span, record_spans, span, span_lines, span_table
from vfp_tpu_torch.wm import CorrShuffler, DeCorrShuffler, DtcwtKey

from torch_parity import natural_frames

torch.set_num_threads(1)

H, W, B = 64, 96, 4
MARK_CHILDREN = ["transfer.stage_copy", "transfer.h2d_enqueue", "codec.mark",
                 "transfer.d2h_enqueue"]


def _frames(k, seed=0):
    return natural_frames(np.random.RandomState(seed), k, H, W)


def _wm(key=0):
    return CorrShuffler(key=key).generate_wm(None, DtcwtKey().wm_capacity((H, W, 3)))


def _by_batch(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s.batch, []).append(s)
    return out


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.t0)


def test_off_records_nothing():
    marker = FrameMarker(DtcwtKey(), _wm(), B, device="cpu")
    assert span("marker.mark", 3, batch=profiling.NEW_BATCH) is profiling.OFF
    assert profiling.current_batch() is None
    marker.mark(_frames(3))
    profiling.record("embedder.read_wait", 1, 2)
    with record_spans() as spans:
        pass
    assert spans == []


def test_frame_marker_spans_names_parents_batches_items():
    marker = FrameMarker(DtcwtKey(), _wm(), B, device="cpu")
    with record_spans() as spans:
        marker.mark(_frames(3))
        marker.mark(_frames(4, seed=1))
    batches = _by_batch(spans)
    assert None not in batches and len(batches) == 2
    for k, group in zip((3, 4), (batches[i] for i in sorted(batches))):
        (top,) = [s for s in group if s.parent is None]
        assert (top.name, top.items) == ("marker.mark", k)
        kids = _children(group, top)
        assert [s.name for s in kids] == MARK_CHILDREN  # no waits on the CPU
        assert all(top.t0 <= s.t0 <= s.t1 <= top.t1 for s in kids)
        items = {s.name: s.items for s in kids}
        assert items["transfer.stage_copy"] == B * H * W * 3  # the padded batch's bytes
        assert items["codec.mark"] == B
        assert {s.thread for s in group} == {threading.get_ident()}


def test_multimarker_collect_on_another_thread_joins_its_batch():
    mm = MultiMarker(DtcwtKey(), [_wm(0), _wm(1)], B, device="cpu")
    got = {}
    with record_spans() as spans:
        handle = mm.submit(_frames(3))

        def collect():
            got["out"] = mm.collect(handle)
            got["thread"] = threading.get_ident()

        t = threading.Thread(target=collect)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert got["out"].shape == (2, 3, H, W, 3)
    (sub,) = [s for s in spans if s.name == "marker.submit"]
    (col,) = [s for s in spans if s.name == "marker.collect"]
    assert (sub.items, col.items) == (3, 3)
    assert handle.batch == sub.batch == col.batch is not None
    assert col.thread == got["thread"] != sub.thread and col.parent is None
    kids = _children(spans, sub)
    assert [s.name for s in kids] == ["transfer.stage_copy", "transfer.h2d_enqueue",
                                      "codec.mark", "codec.mark", "transfer.d2h_enqueue"]
    assert all(s.batch == sub.batch for s in kids)


class _Event:
    """Stands in for a CUDA event: a handle's wait is a host sync."""

    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_a_handles_wait_is_a_sync_span_of_its_batch():
    mm = MultiMarker(DtcwtKey(), [_wm(0)], B, device="cpu")
    with record_spans() as spans:
        handle = mm.submit(_frames(2))
        handle.done = _Event()
        mm.collect(handle)
    assert handle.done.waited == 1
    (col,) = [s for s in spans if s.name == "marker.collect"]
    (wait,) = [s for s in spans if s.name == "sync.result_wait"]
    assert wait.parent == col.id and wait.batch == col.batch == handle.batch


def test_a_sync_span_records_only_for_a_tensor_on_a_card():
    card = SimpleNamespace(is_cuda=True)  # stands in for a CUDA tensor
    assert profiling.sync_span("sync.wm_spectrum", card) is profiling.OFF  # not recording
    with record_spans() as spans:
        with span("codec.mark", 4, batch=profiling.NEW_BATCH):
            with profiling.sync_span("sync.wm_spectrum", torch.zeros(1)):
                pass
            with profiling.sync_span("sync.wm_spectrum", card):
                pass
    (codec,) = [s for s in spans if s.name == "codec.mark"]
    (sync,) = [s for s in spans if s.name == "sync.wm_spectrum"]
    assert (sync.parent, sync.batch) == (codec.id, codec.batch)


def test_frame_extractor_spans():
    marker = FrameMarker(DtcwtKey(), _wm(), B, device="cpu")
    marked = marker.mark(_frames(3))
    ext = FrameExtractor(DtcwtKey(), DeCorrShuffler(key=0), B, device="cpu")
    with record_spans() as spans:
        flags = ext.extract(marked)
    assert flags.shape == (3, 1)
    (top,) = [s for s in spans if s.parent is None]
    assert (top.name, top.items) == ("extractor.extract", 3) and top.batch is not None
    assert [s.name for s in _children(spans, top)] == [
        "transfer.stage_copy", "transfer.h2d_enqueue", "codec.extract", "transfer.d2h_enqueue"]
    assert {s.batch for s in spans} == {top.batch}


def test_self_time_is_the_duration_less_the_children():
    spans = [Span(1, "outer", 0, 100, None, 1, 0, 7),
             Span(2, "inner", 10, 30, 1, 1, 0, 7),
             Span(3, "inner", 40, 70, 1, 1, 0, 7),
             Span(4, "leaf", 45, 50, 3, 1, 0, 7),
             Span(5, "other", 20, 90, None, 1, 0, 8)]  # another thread: no one's child
    assert span_table(spans) == {"outer": (1, 100, 50), "inner": (2, 50, 45),
                                 "leaf": (1, 5, 5), "other": (1, 70, 70)}
    assert span_lines(spans) == [
        "span outer: count 1, total 0.000 ms, self 0.000 ms",
        "span other: count 1, total 0.000 ms, self 0.000 ms",
        "span inner: count 2, total 0.000 ms, self 0.000 ms",
        "span leaf: count 1, total 0.000 ms, self 0.000 ms"]
    with record_spans() as live:
        with span("outer"):
            with span("inner"):
                torch.ones(1000).sum()
    table = span_table(live)
    (o, i) = sorted(live, key=lambda s: s.t0)
    assert table["outer"] == (1, o.t1 - o.t0, (o.t1 - o.t0) - (i.t1 - i.t0))


def test_record_spans_refuses_a_second_recording():
    with record_spans():
        with pytest.raises(RuntimeError):
            with record_spans():
                pass
    assert span("x") is profiling.OFF


class _Reader:
    def __init__(self, frames, n):
        self.frames, self.left = frames, n

    def read_batch(self, n):
        if self.left == 0:
            return None
        self.left -= 1
        return self.frames[:n]

    def close(self):
        pass


class _Writer:
    def __init__(self):
        self.n = 0

    def write_batch(self, batch):
        self.n += len(batch)

    def close(self):
        pass


def test_embedder_stage_seconds_are_the_sums_of_its_spans():
    marker = FrameMarker(DtcwtKey(), _wm(), B, device="cpu")
    writer = _Writer()
    with record_spans() as spans:
        stats = Embedder(_Reader(_frames(B), 3), marker, writer, prefetch=1).start()
    assert stats.frames == writer.n == 3 * B
    for stage in ("read_wait", "write_wait"):
        mine = [s for s in spans if s.name == f"embedder.{stage}"]
        assert len(mine) == (4 if stage == "read_wait" else 3)  # the last read takes the end
        assert stats.stage_seconds[stage] == round(sum(s.t1 - s.t0 for s in mine) / 1e9, 4)
    marks = [s for s in spans if s.name == "marker.mark"]
    assert len(marks) == 3 and len({s.batch for s in marks}) == 3
    assert stats.stage_seconds["compute"] >= round(sum(s.t1 - s.t0 for s in marks) / 1e9, 4)


def test_cli_mark_profile_prints_the_span_table_and_traces_the_spans(tmp_path, capsys):
    src = tmp_path / "in.rawv"
    with RawVideoWriter(src, W, H, fps=6) as w:
        w.write_batch(_frames(6))
    prof = tmp_path / "prof"
    port_cli(["mark", str(src), str(tmp_path / "out.rawv"), "--codec", "dtcwtKey",
              "--profile", str(prof), "--batch-size", str(B), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    table = {ln.split(":")[0]: ln for ln in lines if ln.startswith("span ")}
    assert set(table) == {f"span {n}" for n in ["marker.mark", *MARK_CHILDREN,
                                                "embedder.read_wait", "embedder.write_wait"]}
    assert table["span marker.mark"].startswith("span marker.mark: count 2, total ")
    assert table["span embedder.read_wait"].startswith("span embedder.read_wait: count 3,")
    (trace,) = prof.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"marker.mark", "codec.mark", "transfer.stage_copy"} <= names
    assert span("x") is profiling.OFF  # off again after the run
