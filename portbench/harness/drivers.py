"""The drivers: how a traffic file's ``driver`` hands the program its work.

The decoder and the encoder of a deployment are the harness's own: the
source is an in-memory pool of decoded frames, the sink counts what it
receives, keeps a sample drawn from the seed for the check, and drops the
rest.  Everything between them is ``vfp_tpu_torch`` as a user runs it:

- ``embedder``: ``pipeline.Embedder(reader, FrameMarker(codec, wm, B), sink)``,
  the path of ``cli mark`` without the file reader and writer.
- ``segments``: the loop of ``fingerprint.marker.mark_segments`` without
  file I/O: per segment, ``Shuffler(key).generate_wm(payload_for_segment(s,
  c), capacity)`` for each copy and one ``MultiMarker``; ``submit``s run up
  to ``in_flight`` batches ahead across segment boundaries, and a collector
  thread ``collect``s each handle.
- ``extractor``: ``pipeline.Extractor(reader, cached_bit_extractor(codec,
  key, payload_len, B))``, the path of ``cli detect``, over a leaked clip
  that the reference marked, replayed pass after pass.

Each driver: ``prepare`` makes the inputs, ``build`` the program's objects,
``warm`` runs the same path unmeasured, ``window`` runs it for the
measured seconds and drains, ``release`` drops the program's state and
``check`` compares the answers with the reference.
"""

from __future__ import annotations

import importlib
import queue
import threading
import time

import numpy as np
import torch

from . import frames as content
from . import roofline

PROGRAM = "vfp_tpu_torch"


def _program(module: str):
    return importlib.import_module(f"{PROGRAM}.{module}")


def reference_module(cfg: dict):
    return importlib.import_module(f"reference.{cfg['reference']['module']}")


class Window:
    """What a window did: its host-clock edges and counts."""

    def __init__(self):
        self.t_first = None  # perf_counter_ns of the first read or hand-over
        self.t_last = None  # perf_counter_ns of the sink's last receipt
        self.attempted = 0  # units of work handed to the program
        self.delivered = 0  # units that reached the sink
        self.batches = 0  # input batches handed over
        self.codec_bytes = 0  # least bytes of the codec calls (harness/roofline.py)
        self.latencies_ms: list = []  # per segment, where the driver has segments
        self.receipts: list = []  # (perf_counter_ns, units) of each receipt

    def receive(self, units: int) -> None:
        now = time.perf_counter_ns()
        self.delivered += units
        self.t_last = now
        self.receipts.append((now, units))

    def quarters(self) -> list:
        """Units a second in each quarter of the window: how steady it ran."""
        span = self.t_last - self.t_first
        counts = [0, 0, 0, 0]
        for t, u in self.receipts:
            counts[min(3, (t - self.t_first) * 4 // max(span, 1))] += u
        return [c * 4e9 / max(span, 1) for c in counts]

    def first(self):
        if self.t_first is None:
            self.t_first = time.perf_counter_ns()

    @property
    def seconds(self) -> float:
        return (self.t_last - self.t_first) / 1e9


class Reservoir:
    """A uniform sample of ``k`` units from a stream, drawn from the seed,
    copied into buffers allocated once."""

    def __init__(self, k: int, unit_shape, rng: np.random.Generator):
        self.keys: list = []
        self.buf = np.empty((k, *unit_shape), np.uint8)
        self.rng = rng
        self.seen = 0

    def offer(self, key, unit: np.ndarray) -> None:
        k = len(self.buf)
        if self.seen < k:
            slot = self.seen
            self.keys.append(key)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot >= k:
                self.seen += 1
                return
            self.keys[slot] = key
        np.copyto(self.buf[slot], unit)
        self.seen += 1

    def items(self):
        return list(zip(self.keys, self.buf[: len(self.keys)]))


class Ctx:
    """A cell's settings and the objects every driver shares."""

    def __init__(self, cell, seed: int, device, spans):
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.spans = spans
        self.h, self.w = int(self.cfg["frame_height"]), int(self.cfg["frame_width"])
        self.bs = int(self.cfg["batch_size"])
        self.key = int(self.cfg["key"])
        self.payload = np.array([int(c) for c in self.cfg["payload"]], np.int64)
        self.gen = content.generator(self.seed, self.device)
        # separate streams: content on the device, choices on the host
        self.rng = np.random.default_rng([self.seed % (2**63), 1])

    def frames(self, n: int) -> np.ndarray:
        return content.make(self.cfg["content"], self.gen, n, self.h, self.w, self.device)

    def codec(self):
        utils = _program("utils")
        conf = utils.VfpConfig.from_dict({"codec": self.cfg.get("codec_config", {})})
        return utils.make_codec(self.cfg["codec"], conf)

    def spreader(self):
        return getattr(_program("wm"), self.cfg["spreader"])(key=self.key)


# -- sources and sinks ---------------------------------------------------------------

class PoolReader:
    """Batches cycled out of a pool of frames until the deadline (or the
    batch limit); every batch is a view of the pool."""

    def __init__(self, pool: np.ndarray, win: Window, seconds: float, spans,
                 max_batches: int | None = None):
        self.pool, self.win, self.seconds, self.spans = pool, win, seconds, spans
        self.max_batches = max_batches
        self.pos = 0
        self.deadline = None

    def read_batch(self, n: int):
        with self.spans.span("source"):
            self.win.first()
            if self.deadline is None:
                self.deadline = self.win.t_first + int(self.seconds * 1e9)
            if (time.perf_counter_ns() >= self.deadline
                    or (self.max_batches is not None and self.win.batches >= self.max_batches)):
                return None
            start = self.pos % len(self.pool)
            out = self.pool[start:start + n]
            self.pos += len(out)
            self.win.batches += 1
            self.win.attempted += len(out)
            return out

    def close(self):
        pass


class ClipReader:
    """One pass over a clip, in batches."""

    def __init__(self, clip: np.ndarray, win: Window, spans):
        self.clip, self.win, self.spans = clip, win, spans
        self.pos = 0

    def read_batch(self, n: int):
        with self.spans.span("source"):
            self.win.first()
            if self.pos >= len(self.clip):
                return None
            out = self.clip[self.pos:self.pos + n]
            self.pos += len(out)
            self.win.batches += 1
            self.win.attempted += len(out)
            return out

    def close(self):
        pass


class SampleSink:
    """Counts the marked frames it receives and keeps a reservoir sample,
    keyed by each frame's index in the pool."""

    def __init__(self, win: Window, pool_len: int, sample: Reservoir | None, spans):
        self.win, self.pool_len, self.sample, self.spans = win, pool_len, sample, spans

    def write_batch(self, batch: np.ndarray) -> None:
        with self.spans.span("sink"):
            if self.sample is not None:
                for i, f in enumerate(batch):
                    self.sample.offer((self.win.delivered + i) % self.pool_len, f)
            self.win.receive(len(batch))

    def close(self):
        pass


class TimedMarker:
    """What ``Embedder`` drives: the program's ``FrameMarker`` inside a span."""

    def __init__(self, marker, win: Window, ctx: Ctx):
        self.marker, self.win, self.ctx = marker, win, ctx
        self.batch_size = marker.batch_size

    def mark(self, frames: np.ndarray) -> np.ndarray:
        with self.ctx.spans.span("batch_call"):
            out = self.marker.mark(frames)
        self.win.codec_bytes += roofline.mark_bytes(len(frames), self.ctx.h, self.ctx.w)
        return out


class TimedExtractor:
    """What ``Extractor`` drives: the program's ``FrameExtractor`` inside a span."""

    def __init__(self, extractor, win: Window, ctx: Ctx, payload_len: int):
        self.ext, self.win, self.ctx, self.payload_len = extractor, win, ctx, payload_len
        self.batch_size = extractor.batch_size

    def extract(self, frames: np.ndarray) -> np.ndarray:
        with self.ctx.spans.span("batch_call"):
            out = self.ext.extract(frames)
        self.win.codec_bytes += roofline.extract_bytes(len(frames), self.ctx.h, self.ctx.w,
                                                       self.payload_len)
        self.win.receive(len(out))
        return out


# -- comparisons -----------------------------------------------------------------------

def compare_frames(pairs, ref_fn, device, control_fn=None, chunk: int = 8) -> dict:
    """``pairs``: [(program uint8 [H, W, 3], (source frame, watermark key))];
    the reference marks the sources in chunks of frames sharing a watermark.
    With ``control_fn`` (the reference in a lower precision) its output
    stands in the program's place.  Returns the largest absolute byte
    difference and the differing bytes per million."""
    worst, differ, total = 0, 0, 0
    for prog, ref in _ref_chunks(pairs, ref_fn, device, chunk, control_fn):
        d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
        worst = max(worst, int(d.max()))
        differ += int(np.count_nonzero(d))
        total += d.size
    return {"max_abs_diff": worst, "diff_ppm": differ * 1e6 / max(total, 1)}


def _ref_chunks(pairs, ref_fn, device, chunk, control_fn):
    groups: dict = {}
    for prog, (frame, wm_key) in pairs:
        groups.setdefault(wm_key, []).append((prog, frame))
    for wm_key, items in groups.items():
        for i in range(0, len(items), chunk):
            part = items[i:i + chunk]
            x = torch.from_numpy(np.stack([f for _, f in part])).to(device)
            ref = ref_fn(x, wm_key).cpu().numpy()
            progs = ([p for p, _ in part] if control_fn is None
                     else control_fn(x, wm_key).cpu().numpy())
            yield from zip(progs, ref)


# -- drivers ---------------------------------------------------------------------------

class EmbedderDriver:
    kind = "mark"

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.pool_n = int(t["pool_frames"])
        self.sample_k = int(t["check_frames"])
        self.prefetch = int(t.get("prefetch", 2))

    def prepare(self):
        self.pool = self.ctx.frames(self.pool_n)

    def build(self):
        pipeline = _program("pipeline")
        c = self.ctx
        self.codec = c.codec()
        wm = c.spreader().generate_wm(c.payload, self.codec.wm_capacity((c.h, c.w, 3)))
        self.marker = pipeline.FrameMarker(self.codec, wm, c.bs, device=c.device)

    def warm(self):
        self._run(1e9, self.ctx.traffic.get("warm_batches", 2 * self.pool_n // self.ctx.bs), None)

    def window(self, seconds: float) -> Window:
        self.sample = Reservoir(self.sample_k, (self.ctx.h, self.ctx.w, 3), self.ctx.rng)
        return self._run(seconds, None, self.sample)

    def _run(self, seconds, max_batches, sample) -> Window:
        pipeline = _program("pipeline")
        c = self.ctx
        win = Window()
        reader = PoolReader(self.pool, win, seconds, c.spans, max_batches)
        sink = SampleSink(win, self.pool_n, sample, c.spans)
        pipeline.Embedder(reader, TimedMarker(self.marker, win, c), sink,
                          prefetch=self.prefetch).start()
        return win

    def release(self):
        self.marker = self.codec = None

    def control_sample(self):
        """The sample a window would keep, drawn without running the program."""
        c = self.ctx
        self.sample = Reservoir(self.sample_k, (1, 1, 1), c.rng)
        for i in c.rng.integers(0, self.pool_n, self.sample_k):
            self.sample.offer(int(i), np.zeros((1, 1, 1), np.uint8))

    def check(self, control: bool = False) -> dict:
        c = self.ctx
        ref = reference_module(c.cfg)
        wm = ref.make_watermark(c.payload, c.key, c.h, c.w)
        params = c.cfg["reference"].get("params", {})
        pairs = [(f, (self.pool[i], 0)) for i, f in self.sample.items()]
        return compare_frames(
            pairs, lambda x, _: ref.mark(x, wm, **params), c.device,
            (lambda x, _: ref.mark(x, wm, dtype=torch.bfloat16, **params)) if control else None)


class SegmentsDriver:
    kind = "mark"

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.pool_n = int(t["pool_frames"])
        self.seg_n = int(t["segment_frames"])
        self.copies = int(t["copies"])
        self.in_flight = int(t["in_flight"])
        self.sample_k = int(t["check_frames"])

    def prepare(self):
        pool = self.ctx.frames(self.pool_n)
        # a ring read as one array, so that every segment is a view
        self.ring = np.concatenate([pool, pool[: self.seg_n]])

    def build(self):
        self.codec = self.ctx.codec()
        self.generator = _program("wm").Shuffler(key=self.ctx.key)

    def warm(self):
        self._run(1e9, int(self.ctx.traffic.get("warm_segments", 2)), None)

    def window(self, seconds: float) -> Window:
        c = self.ctx
        self.sample = Reservoir(self.sample_k, (self.copies, c.h, c.w, 3), c.rng)
        return self._run(seconds, None, self.sample)

    def offset(self, s: int) -> int:
        return (s * self.seg_n) % self.pool_n

    def _run(self, seconds, max_segments, sample) -> Window:
        c = self.ctx
        pipeline = _program("pipeline")
        payload_for_segment = _program("fingerprint.payloads").payload_for_segment
        win = Window()
        q: queue.Queue = queue.Queue(maxsize=self.in_flight)
        err: list = []
        handed: dict = {}
        nb = -(-self.seg_n // c.bs)

        def collector():
            while True:
                item = q.get()
                if item is None:
                    return
                if err:
                    continue
                s, bi, mm, handle = item
                try:
                    with c.spans.span("collect"):
                        out = mm.collect(handle)  # [V, k, H, W, 3]
                    with c.spans.span("sink"):
                        if sample is not None:
                            for i in range(out.shape[1]):
                                sample.offer((s, bi * c.bs + i), out[:, i])
                        win.receive(out.shape[0] * out.shape[1])
                        if bi == nb - 1:
                            win.latencies_ms.append((win.t_last - handed.pop(s)) / 1e6)
                except Exception as e:  # raised by the submitting thread below
                    err.append(e)

        ct = threading.Thread(target=collector, daemon=True)
        ct.start()
        cap = self.codec.wm_capacity((c.h, c.w, 3))
        try:
            s = 0
            while not err:
                win.first()
                if (time.perf_counter_ns() - win.t_first >= seconds * 1e9
                        or (max_segments is not None and s >= max_segments)):
                    break
                with c.spans.span("source"):
                    o = self.offset(s)
                    frames = self.ring[o:o + self.seg_n]
                    handed[s] = time.perf_counter_ns()
                with c.spans.span("marker"):
                    wms = [self.generator.generate_wm(payload_for_segment(s, cp), cap)
                           for cp in range(self.copies)]
                    mm = pipeline.MultiMarker(self.codec, wms, batch_size=c.bs, device=c.device)
                for bi in range(nb):
                    part = frames[bi * c.bs:(bi + 1) * c.bs]
                    with c.spans.span("batch_call"):
                        handle = mm.submit(part)
                    win.batches += 1
                    win.attempted += self.copies * len(part)
                    win.codec_bytes += roofline.mark_bytes(len(part), c.h, c.w, self.copies)
                    with c.spans.span("queue_wait"):
                        q.put((s, bi, mm, handle))
                s += 1
        finally:
            q.put(None)
            ct.join()
        if err:
            raise err[0]
        return win

    def release(self):
        self.codec = self.generator = None

    def control_sample(self, segments: int = 300):
        """The sample a window would keep, drawn without running the program."""
        c = self.ctx
        self.sample = Reservoir(self.sample_k, (self.copies, 1, 1, 1), c.rng)
        for _ in range(self.sample_k):
            unit = (int(c.rng.integers(0, segments)), int(c.rng.integers(0, self.seg_n)))
            self.sample.offer(unit, np.zeros((self.copies, 1, 1, 1), np.uint8))

    def check(self, control: bool = False) -> dict:
        c = self.ctx
        ref = reference_module(c.cfg)
        params = c.cfg["reference"].get("params", {})
        pay = importlib.import_module("reference.spread").segment_payload
        wms: dict = {}
        pairs = []
        for (s, f), variants in self.sample.items():
            frame = self.ring[self.offset(s) + f]
            for cp, prog in enumerate(variants):
                k = (s % 16, cp)
                if k not in wms:
                    wms[k] = ref.make_watermark(pay(s, cp), c.key, c.h, c.w)
                pairs.append((prog, (frame, k)))
        return compare_frames(
            pairs, lambda x, k: ref.mark(x, wms[k], **params), c.device,
            (lambda x, k: ref.mark(x, wms[k], dtype=torch.bfloat16, **params)) if control else None)


class ExtractorDriver:
    kind = "detect"

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.segments = int(t["segments"])
        self.seg_n = int(t["segment_frames"])
        self.copies = int(t["copies"])
        self.prefetch = int(t.get("prefetch", 2))

    def prepare(self):
        """The leaked clip: segment s from copy d_s, d the viewer's number in
        base ``copies``, marked by the reference."""
        c = self.ctx
        ref = reference_module(c.cfg)
        spread = importlib.import_module("reference.spread")
        params = c.cfg["reference"].get("params", {})
        self.viewer = int(c.rng.integers(0, self.copies ** self.segments))
        v, self.digits = self.viewer, []
        for _ in range(self.segments):
            self.digits.append(v % self.copies)
            v //= self.copies
        self.digits.reverse()
        clip = c.frames(self.segments * self.seg_n)
        self.truth = np.empty((len(clip), len(c.payload)), np.uint8)
        with torch.no_grad():
            for s, d in enumerate(self.digits):
                pay = spread.segment_payload(s, d)
                wm = ref.make_watermark(pay, c.key, c.h, c.w)
                for i in range(s * self.seg_n, (s + 1) * self.seg_n, 8):
                    j = min(i + 8, (s + 1) * self.seg_n)
                    x = torch.from_numpy(clip[i:j]).to(c.device)
                    clip[i:j] = ref.mark(x, wm, **params).cpu().numpy()
                self.truth[s * self.seg_n:(s + 1) * self.seg_n] = pay
        self.clip = clip

    def build(self):
        c = self.ctx
        self.codec = c.codec()
        self.extractor = _program("pipeline").cached_bit_extractor(
            self.codec, c.key, len(c.payload), c.bs, device=c.device)

    def warm(self):
        self._run(1e9, 1)

    def window(self, seconds: float) -> Window:
        return self._run(seconds, None)

    def _run(self, seconds, max_passes) -> Window:
        c = self.ctx
        pipeline = _program("pipeline")
        win = Window()
        self.passes = []
        proxy = TimedExtractor(self.extractor, win, c, len(c.payload))
        while True:
            win.first()
            if (time.perf_counter_ns() - win.t_first >= seconds * 1e9
                    or (max_passes is not None and len(self.passes) >= max_passes)):
                break
            res = pipeline.Extractor(ClipReader(self.clip, win, c.spans), proxy,
                                     prefetch=self.prefetch).start()
            self.passes.append(res.payloads)
        return win

    def release(self):
        self.extractor = self.codec = None

    def trace_viewer(self, payloads: np.ndarray):
        """The copy digits of one pass: each segment's majority payload,
        its low four bits; None where the top four bits name another segment."""
        digits = []
        for s in range(self.segments):
            rows = payloads[s * self.seg_n:(s + 1) * self.seg_n]
            vals, counts = np.unique(rows, axis=0, return_counts=True)
            top = vals[np.argmax(counts)]
            seg = int("".join(map(str, top[:4])), 2)
            digits.append(int("".join(map(str, top[4:8])), 2) if seg == s % 16 else None)
        return digits

    def control_sample(self):
        """The control decodes the clip once, in place of the program's passes."""
        c = self.ctx
        ref = reference_module(c.cfg)
        spread = importlib.import_module("reference.spread")
        params = {k: v for k, v in c.cfg["reference"].get("params", {}).items() if k == "scale"}
        planes = []
        for i in range(0, len(self.clip), 8):
            x = torch.from_numpy(self.clip[i:i + 8]).to(c.device)
            planes.append(ref.decode(x, dtype=torch.bfloat16, **params).cpu().numpy())
        self.passes = [spread.despread_bits(np.concatenate(planes), c.key, len(c.payload))]

    def check(self, control: bool = False) -> dict:
        payload_errors = viewer_errors = 0
        for p in self.passes:
            if p.shape != self.truth.shape:
                payload_errors += len(self.truth)
                viewer_errors += 1
                continue
            payload_errors += int(np.count_nonzero(np.any(p != self.truth, axis=1)))
            viewer_errors += int(self.trace_viewer(p) != self.digits)
        return {"payload_errors": payload_errors, "viewer_errors": viewer_errors}


DRIVERS = {"embedder": EmbedderDriver, "segments": SegmentsDriver, "extractor": ExtractorDriver}
