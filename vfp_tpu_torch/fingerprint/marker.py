"""Per-segment variant marking + verification (port of
``vfp_tpu/fingerprint/marker.py``).

Each segment's frames are decoded ONCE into a batch and all N copy variants
are marked from that same upload; verification decodes each marked file
once and compares the majority pattern against the expected payload.
Marking runs ahead of the writer: ``MultiMarker.submit`` enqueues a batch's
upload, marks and downloads on the card and returns, and a writer thread
collects each handle and writes the variants, so the card works on later
batches (across segment boundaries) while earlier ones are written.

Variants are ``marked_segN_copyC.mp4`` through the ffmpeg pipe writer where
an ``ffmpeg`` binary is on PATH (the JAX module's choice); without one,
``.rawv`` for ``.rawv`` segments and MJPEG ``.avi`` for any other.  Each
shares its segment's audio sidecar where the segment has one
(``segment_NNN.audio.mp4`` -> ``marked_segN_copyC.audio.mp4``; the ffmpeg
route's segments carry their audio and have none).  ``_read_all`` reads
every container the port reads.  Under the LL transport
(``pipeline/lowlink.py``, ``VFP_LOWLINK=1``) one ``PackedTwoPlane`` per
frame size packs the device calls of every segment with 3 or more copies.
"""

from __future__ import annotations

import json
import logging
import queue
import shutil
import struct
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..io import ffmpeg, open_reader, open_writer
from ..io.mp4 import audio_sidecar
from ..io.readers import RAWV_MAGIC, require_supported
from ..pipeline import MultiMarker, cached_bit_extractor, use_lowlink
from ..pipeline.lowlink import PackedTwoPlane, default_wire
from ..utils.device import resolve_device
from ..wm import DwtDctSvd, Shuffler
from .payloads import payload_for_segment

logger = logging.getLogger(__name__)


@dataclass
class MarkedSegment:
    file: str
    segment_number: int
    copy_index: int
    payload: list = field(default_factory=list)


def _read_all(file):
    """All frames of a segment as one [n, H, W, 3] array, and its fps.

    A ``.rawv`` segment is one np.fromfile: a reader's per-open cost
    dominates on the few-frame segments HLS produces.  Any other container
    goes through ``open_reader`` (the ffmpeg pipe where the binary is on
    PATH, else the MJPEG ``.avi``, ``.mp4``/``.m4s`` or ``.y4m`` reader).
    A corrupt file (truncated header, zero dims, no whole frame, bad JPEG
    data, an MP4 whose video is not JPEG) raises IOError, which the
    pipelined verify/trace callers take as (None, 0.0) for that file."""
    require_supported(file)
    if Path(file).suffix != ".rawv":
        reader = open_reader(file)
        chunks = []
        try:
            fps = reader.fps
            while (b := reader.read_batch(32)) is not None:
                chunks.append(b)
        finally:
            reader.close()
        if not chunks:
            raise IOError(f"empty segment: {file}")
        return np.concatenate(chunks), fps
    with open(file, "rb") as f:
        head = f.read(24)
        if head[:8] != RAWV_MAGIC:
            raise IOError(f"not a VFP raw video file: {file}")
        if len(head) < 24:
            raise IOError(f"truncated rawv header: {file}")
        w, h, fps_num, fps_den = struct.unpack("<IIII", head[8:])
        if h == 0 or w == 0:
            raise IOError(f"invalid rawv dims {w}x{h}: {file}")
        data = np.fromfile(f, np.uint8)
    n = data.size // (h * w * 3)
    if n == 0:
        raise IOError(f"empty segment: {file}")
    return data[: n * h * w * 3].reshape(n, h, w, 3), fps_num / max(fps_den, 1)


def mark_segments(
    segments,
    marked_dir,
    copies: int = 1,
    key: int = 0,
    codec=None,
    batch_size: int = 16,
    quality: int = 95,
    out_ext: str | None = None,
    resume: bool = False,
    first_segment_number: int = 0,
    stats: dict | None = None,
    *,
    device="cuda",
):
    """Mark every segment in ``copies`` variants on ``device``.

    Variants are written as ``out_ext`` files; by default ``.mp4`` where an
    ``ffmpeg`` binary is on PATH, else ``.rawv`` for a ``.rawv`` segment and
    MJPEG ``.avi`` at ``quality`` for any other.  A segment's audio sidecar,
    where it has one, is copied beside each of its variants.

    Returns (marked: list[MarkedSegment], segment_payloads, segment_copies):
    the dicts use the reference's JSON manifest schemas
    (reference: tests/mark_video_to_hls.py:406-427).

    With ``resume``, variants whose files exist are skipped (a segment with
    none missing is not even decoded).  When ``stats`` is a dict it gets
    ``wall_seconds``, ``host_busy_seconds`` (decode + encode_write) and
    ``stage_seconds``: the busy seconds of ``decode`` (decode thread),
    ``device_full`` (writer thread blocked in ``collect``: the card's work
    and the downloads not yet hidden) and ``encode_write`` (writer), and the
    waits that complete the accounting: ``decode_wait`` and ``queue_wait``
    (main thread blocked on the decode future / the full writer queue) and
    ``writer_idle`` (writer blocked on an empty queue).  Under the LL
    transport, as in the JAX function, ``stage_seconds`` also has the
    transport's stages (``host_ll``, ``dispatch``, ``link_fetch``,
    ``recentre``, ``host_qim``, ``reconstruct``; ``device_full`` stays 0),
    ``host_busy_seconds`` adds its host stages, and ``stats`` gets
    ``link_device_wait_seconds`` and, where a packer ran,
    ``packed_device_calls``; the port adds ``packed_device_frames`` (the
    frames of those calls) and ``host_routed_batches`` (the batches the u8
    wire's flat-content hysteresis marked on the host).
    """
    device = resolve_device(device)
    codec = codec or DwtDctSvd()
    marked_dir = Path(marked_dir)
    marked_dir.mkdir(parents=True, exist_ok=True)
    if out_ext is None and ffmpeg.have_ffmpeg():
        out_ext = ".mp4"

    def out_file(seg_idx, seg_file, c):
        ext = out_ext or (".rawv" if Path(seg_file).suffix == ".rawv" else ".avi")
        return marked_dir / f"marked_seg{seg_idx}_copy{c}{ext}"

    marked: list[MarkedSegment] = []
    segment_payloads: dict = {}
    segment_copies: dict = {"segments": {}}
    generator = Shuffler(key=key)
    plans = [
        (seg_idx, seg_file,
         [c for c in range(copies) if not (resume and out_file(seg_idx, seg_file, c).exists())])
        for seg_idx, seg_file in enumerate(segments, start=first_segment_number)
    ]

    pool = ThreadPoolExecutor(max_workers=1)
    decode_futs: dict = {}
    t_wall0 = time.perf_counter()
    ss = {"decode": 0.0, "device_full": 0.0, "encode_write": 0.0, "decode_wait": 0.0,
          "queue_wait": 0.0, "writer_idle": 0.0}
    lowlink = use_lowlink(codec)
    if lowlink:
        ss.update(dict.fromkeys(("host_ll", "dispatch", "link_fetch", "recentre", "host_qim",
                                 "reconstruct"), 0.0))
    # each segment's transport stage seconds (small dicts, not the markers:
    # those hold every watermark and mask of their segment)
    lowlink_stages: list = []
    host_routed = 0
    packers: dict = {}  # (h, w) -> PackedTwoPlane shared across segments

    def _packer(h, w, n_variants):
        # the two-plane calls depend only on the LL, so one call carries
        # frames of many segments; each marker selects its variants after
        if n_variants < 3 or not lowlink or default_wire() == "host":
            return None
        if (h, w) not in packers:
            packers[(h, w)] = PackedTwoPlane(codec, pack=max(batch_size, 16), device=device)
        return packers[(h, w)]

    def _read_timed(file):
        t0 = time.perf_counter()
        out = _read_all(file)
        ss["decode"] += time.perf_counter() - t0
        return out

    def _prefetch(pi: int):
        if pi < len(plans) and plans[pi][2] and plans[pi][0] not in decode_futs:
            decode_futs[plans[pi][0]] = pool.submit(_read_timed, plans[pi][1])

    # bounded: each "mark" item holds an in-flight handle and its host
    # arrays, so maxsize is the pipeline depth (submits run ahead of the
    # writer by up to 3 batches, across segment boundaries)
    wq: queue.Queue = queue.Queue(maxsize=3)
    werr: list = []
    broken: list = []  # files touched at/after the first writer error

    def _writer_loop():
        while True:
            t_idle = time.perf_counter()
            item = wq.get()
            ss["writer_idle"] += time.perf_counter() - t_idle
            if item is None:
                return
            try:
                if werr:
                    # after an error: drain, but record every affected file so
                    # it can be unlinked — resume=True treats existing files as
                    # complete, so leaving truncated ones would silently skip
                    # their segments on re-run
                    broken.extend(item[-1])
                    if item[0] == "close":
                        for wtr in item[1].values():
                            try:
                                wtr.close()
                            except Exception:  # best effort: the first error is raised
                                pass
                elif item[0] == "mark":
                    _, mm, handle, writers, todo, _paths = item
                    t0 = time.perf_counter()
                    out = mm.collect(handle)  # waits on this batch's event alone
                    t1 = time.perf_counter()
                    if mm._ll is None:  # the transport times its own stages
                        ss["device_full"] += t1 - t0
                    for vi, c in enumerate(todo):
                        writers[c].write_batch(out[vi])
                    ss["encode_write"] += time.perf_counter() - t1
                else:
                    t0 = time.perf_counter()
                    for wtr in item[1].values():
                        wtr.close()
                    ss["encode_write"] += time.perf_counter() - t0
            except Exception as e:  # re-raised by the submitting thread below
                werr.append(e)
                broken.extend(item[-1])

    wt = threading.Thread(target=_writer_loop, daemon=True)
    wt.start()

    current = None  # (writers, paths) of the segment whose close is not queued yet
    try:
        _prefetch(0)
        for pi, (seg_idx, seg_file, todo) in enumerate(plans):
            _prefetch(pi + 1)
            if werr:  # writer already failed: stop submitting device work
                break
            if todo:
                t_dw = time.perf_counter()
                frames, fps = decode_futs.pop(seg_idx).result()  # decoded ONCE
                ss["decode_wait"] += time.perf_counter() - t_dw
                h, w = frames.shape[1:3]
                wms = [generator.generate_wm(payload_for_segment(seg_idx, c),
                                             codec.wm_capacity((h, w, 3)))
                       for c in todo]
                mm = MultiMarker(codec, wms, batch_size=batch_size,
                                 packer=_packer(h, w, len(todo)), device=device)
                if mm._ll is not None:
                    lowlink_stages.append(mm._ll.stage_seconds)
                paths = [str(out_file(seg_idx, seg_file, c)) for c in todo]
                writers = {c: open_writer(out_file(seg_idx, seg_file, c), w, h, fps, quality)
                           for c in todo}
                current = (writers, paths)
                for start in range(0, len(frames), batch_size):
                    if werr:
                        break
                    handle = mm.submit(frames[start : start + batch_size])
                    t_qw = time.perf_counter()
                    wq.put(("mark", mm, handle, writers, todo, paths))
                    ss["queue_wait"] += time.perf_counter() - t_qw
                wq.put(("close", writers, paths))
                current = None
                if mm._ll is not None:  # its submits are done: the count is final
                    host_routed += mm._ll.host_batches
            # audio rides along: every variant of this segment shares the
            # source segment's sidecar (the splice paths mux it back)
            src_audio = audio_sidecar(seg_file)
            seg_entry = []
            for copy_index in range(copies):
                payload = payload_for_segment(seg_idx, copy_index)
                f = out_file(seg_idx, seg_file, copy_index)
                if src_audio.exists() and not audio_sidecar(f).exists():
                    shutil.copy2(src_audio, audio_sidecar(f))
                marked.append(MarkedSegment(file=str(f), segment_number=seg_idx,
                                            copy_index=copy_index, payload=payload.tolist()))
                seg_entry.append(
                    {"file": f.name, "payload": payload.tolist(), "copy_index": copy_index})
                segment_payloads[f"{seg_idx}_{copy_index}"] = payload.tolist()
                logger.info("marked segment %d copy %d -> %s", seg_idx, copy_index, f)
            segment_copies["segments"][str(seg_idx)] = seg_entry
        for p in packers.values():  # dispatch a tail partial chunk now, not at
            p.flush()  # the writer's collect
    except BaseException as e:
        # a failure here (a launch, a read): the writer drains from now on,
        # recording every file it touches, and the open segment is closed
        werr.append(e)
        if current is not None:
            wq.put(("close", *current))
        raise
    finally:
        wq.put(None)
        wt.join()
        pool.shutdown(wait=False)
        # unlink every file touched at/after the failure so a resume=True
        # rerun re-marks those segments instead of trusting truncated output
        for p in set(broken):
            Path(p).unlink(missing_ok=True)
    if werr:
        raise werr[0]

    segment_copies.update(
        {
            "total_segments": len(segments),
            "copies_per_segment": copies,
            "total_marked_segments": len(marked),
        }
    )
    if stats is not None:
        # summed after the join: the writer thread owned the collects
        for st in lowlink_stages + [p.stage_seconds for p in packers.values()]:
            for k, v in st.items():
                ss[k] += v
        stats["wall_seconds"] = round(time.perf_counter() - t_wall0, 3)
        stats["stage_seconds"] = {k: round(v, 3) for k, v in ss.items()}
        host = ss["decode"] + ss["encode_write"]
        if lowlink:
            host += ss["host_ll"] + ss["recentre"] + ss["host_qim"] + ss["reconstruct"]
            stats["link_device_wait_seconds"] = round(
                ss["dispatch"] + ss["link_fetch"] + ss["device_full"], 3)
            stats["host_routed_batches"] = host_routed
            if packers:
                stats["packed_device_calls"] = sum(p.calls for p in packers.values())
                stats["packed_device_frames"] = sum(sum(p.call_frames)
                                                    for p in packers.values())
        stats["host_busy_seconds"] = round(host, 3)
    return marked, segment_payloads, segment_copies


def verify_segment(marked_file, expected_payload, codec=None, key: int = 0,
                   batch_size: int = 16, *, device="cuda"):
    """Decode a marked segment once; (majority_pattern, frequency, success).

    Success = majority pattern equals the expected payload (the reference
    additionally gates frequency >= 0.5 at the workflow level,
    tests/mark_video_to_hls.py:381).
    """
    device = resolve_device(device)
    codec = codec or DwtDctSvd()
    expected = np.asarray(expected_payload)
    # fixed threshold: QIM bit planes are 0/1, and the all-zero payload of
    # segment 0 copy 0 is unrecoverable under the reference's midpoint rule
    fx = cached_bit_extractor(codec, key, int(expected.size), batch_size, device=device)
    frames, _ = _read_all(marked_file)
    payloads = np.concatenate(
        [fx.extract(frames[s : s + batch_size]) for s in range(0, len(frames), batch_size)]
    )
    pattern, count = Counter(map(tuple, payloads.tolist())).most_common(1)[0]
    return (np.array(pattern, np.uint8), count / len(payloads),
            bool(np.array_equal(pattern, expected)))


def segment_majorities(files, payload_len: int, codec=None, key: int = 0,
                       batch_size: int = 16, depth: int = 3, *, device="cuda"):
    """Pipelined majority-vote decode over segment files.

    Two schedulings on top of the serial loop, with identical per-file
    votes: (1) file i+1 is read on a thread while earlier batches are on the
    card (FrameExtractor.submit/collect, up to ``depth`` in flight); (2)
    frames are packed ACROSS file boundaries into uniform batch_size chunks,
    so short HLS segments cost one launch per batch_size frames, not one per
    file.  Returns [(pattern, frequency), ...] in file order; (None, 0.0)
    for unreadable/empty files."""
    device = resolve_device(device)
    codec = codec or DwtDctSvd()
    files = list(files)
    fx = cached_bit_extractor(codec, key, payload_len, batch_size, device=device)
    results: list = [(None, 0.0)] * len(files)
    votes: list = [[] for _ in files]  # per-file [n, payload_len] pieces
    pool = ThreadPoolExecutor(max_workers=1)
    futs: dict = {}
    inflight: deque = deque()  # (handle, [(file_idx, n), ...])
    pend_frames: list = []
    pend_meta: list = []
    pend_shape = None  # (H, W) of the chunk being packed

    def _prefetch(i):
        if i < len(files) and i not in futs:
            futs[i] = pool.submit(_read_all, files[i])

    def _flush():
        nonlocal pend_frames, pend_meta
        if not pend_frames:
            return
        chunk = (pend_frames[0] if len(pend_frames) == 1
                 else np.concatenate(pend_frames))
        inflight.append((fx.submit(chunk), pend_meta))
        pend_frames, pend_meta = [], []

    def _drain():
        handle, meta = inflight.popleft()
        bits = fx.collect(handle)
        off = 0
        for i, n in meta:
            votes[i].append(bits[off : off + n])
            off += n

    try:
        _prefetch(0)
        for i in range(len(files)):
            _prefetch(i + 1)
            try:
                frames, _ = futs.pop(i).result()
            except IOError:  # empty/unreadable segment -> (None, 0.0)
                continue
            if pend_shape != frames.shape[1:3]:
                _flush()  # mixed-dim inputs: never pack across a dim change
                pend_shape = frames.shape[1:3]
            pos = 0
            while pos < len(frames):
                room = batch_size - sum(n for _, n in pend_meta)
                take = min(room, len(frames) - pos)
                pend_frames.append(frames[pos : pos + take])
                pend_meta.append((i, take))
                pos += take
                if take == room:
                    _flush()
                    while len(inflight) > depth:
                        _drain()
        _flush()
        while inflight:
            _drain()
    finally:
        pool.shutdown(wait=False)
    for i, pieces in enumerate(votes):
        if not pieces:
            continue
        payloads = np.concatenate(pieces)
        pattern, count = Counter(map(tuple, payloads.tolist())).most_common(1)[0]
        results[i] = (np.array(pattern, np.uint8), count / len(payloads))
    return results


def verify_segments(marked, codec=None, key: int = 0, batch_size: int = 16,
                    depth: int = 3, *, device="cuda"):
    """Pipelined verify over a list of MarkedSegment (or (file, payload)
    pairs).  Returns [(pattern, frequency, success), ...] in order, each
    element identical to verify_segment's result (same decode, same majority
    vote; only the scheduling differs).  All payloads must share one length
    (they do: payload_for_segment is fixed-width)."""
    items = [(m.file, m.payload) if isinstance(m, MarkedSegment) else tuple(m)
             for m in marked]
    if not items:
        return []
    payload_len = int(np.asarray(items[0][1]).size)
    maj = segment_majorities([f for f, _ in items], payload_len, codec=codec,
                             key=key, batch_size=batch_size, depth=depth, device=device)
    return [
        (pattern, freq,
         bool(pattern is not None
              and np.array_equal(pattern, np.asarray(payload))))
        for (pattern, freq), (_, payload) in zip(maj, items)
    ]


def write_manifests(base_dir, segment_payloads, segment_copies, segment_map=None, failed=None):
    """Emit the reference's JSON manifests (tests/mark_video_to_hls.py:406-434)."""
    base_dir = Path(base_dir)
    (base_dir / "segment_payloads.json").write_text(json.dumps(segment_payloads, indent=2))
    (base_dir / "segment_copies.json").write_text(json.dumps(segment_copies, indent=2))
    if segment_map is not None:
        (base_dir / "segment_mapping.json").write_text(
            json.dumps(
                {
                    "hls_to_watermarked": segment_map,
                    "description": "Maps HLS segment files to their source watermarked segment files",
                },
                indent=2,
            )
        )
    if failed:
        (base_dir / "failed_segments.json").write_text(json.dumps(failed, indent=2))
