"""The port's ffmpeg route (``vfp_tpu_torch/io/ffmpeg.py``, ``io/probe.py``
and the ffmpeg branches of the readers, writers, segmenter, marker, HLS,
leak, CLI and service) against the JAX package's, on the CPU.

No ffmpeg binary is needed: ``tests/ffmpeg_shim`` (a fake ``ffmpeg`` and
``ffprobe`` over the VFPRAWV1 container, which exit 2 on any argument
pattern the real calls do not use) goes first on PATH, as in
``tests/test_ffmpeg_shim.py``, and both packages' cached ``have_ffmpeg`` are
cleared before and after.  The shim copies frame bytes, so its files are
VFPRAWV1 under ``.mp4``/``.m4s`` names and every step is lossless.

Sizes: the JAX shim tests' (48x64 ``natural_frames`` at 6 fps, 1 s segments,
12 frames, 2 copies, batch 4); the JAX marker on its full-frame path
(VFP_LOWLINK=0).  Stated tolerance: probe dicts, pipe batches, segment,
concat and ``.m4s`` bytes, playlists, argv lists, manifests, verify and
trace decisions exactly equal; marked variant frames equal on >= 99.9% of
pixels each (the ±1 class of ``test_torch_fingerprint.py``).
"""

import contextlib
import importlib
import io
import json
import os
import shutil
import stat
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import vfp_tpu.fingerprint.hls as jhls
import vfp_tpu.io.ffmpeg as jffmpeg
from vfp_tpu import fingerprint as jfp
from vfp_tpu.fingerprint.leak import concatenate_segments as jax_concatenate
from vfp_tpu.fingerprint.marker import write_manifests as jax_write_manifests
from vfp_tpu.fingerprint.segmenter import segment_video as jax_segment_video
from vfp_tpu_torch import fingerprint as tfp
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.fingerprint import hls as thls
from vfp_tpu_torch.fingerprint.leak import concatenate_segments as port_concatenate
from vfp_tpu_torch.fingerprint.marker import MarkedSegment, write_manifests
from vfp_tpu_torch.io import (
    FFmpegPipeReader,
    FFmpegPipeWriter,
    MjpegAviReader,
    MjpegAviWriter,
    Mp4MjpegReader,
    RawVideoReader,
    RawVideoWriter,
    Y4MReader,
    Y4MWriter,
    ffmpeg as tffmpeg,
    mp4 as tmp4,
    open_reader,
    open_writer,
    probe as port_probe,
)
from vfp_tpu_torch.io.avi import iter_video_chunks
from vfp_tpu_torch.native import NativeRawVideoReader, NativeRawVideoWriter
from vfp_tpu_torch.serve import app as tapp

from test_torch_serve import _multipart, _req

# the modules (each package's io/__init__ binds the name ``probe`` to the function)
jprobe = importlib.import_module("vfp_tpu.io.probe")
tprobe = importlib.import_module("vfp_tpu_torch.io.probe")

torch.set_num_threads(1)
SHIM_DIR = Path(__file__).parent / "ffmpeg_shim"
H, W, FPS, N = 48, 64, 6.0, 12
CPU = {"device": "cpu"}
PAYLOAD = "01100101"


def _clear_caches():
    jffmpeg.have_ffmpeg.cache_clear()
    tffmpeg.have_ffmpeg.cache_clear()


@pytest.fixture
def shim(monkeypatch):
    """``tests/ffmpeg_shim`` first on PATH, both packages' caches cleared."""
    for name in ("ffmpeg", "ffprobe"):
        p = SHIM_DIR / name
        p.chmod(p.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    monkeypatch.setenv("PATH", f"{SHIM_DIR}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("VFP_LOWLINK", "0")
    _clear_caches()
    yield
    _clear_caches()


def _which(found: bool):
    return SimpleNamespace(which=lambda name, *a, **k: f"/bin/{name}" if found else None)


@pytest.fixture
def no_ffmpeg(monkeypatch):
    """The port as on a host with no ffmpeg and no ffprobe on PATH."""
    monkeypatch.setattr(tffmpeg, "have_ffmpeg", lambda: False)
    monkeypatch.setattr(tprobe, "shutil", _which(False))


def natural_frames(rng, b, h=H, w=W):
    small = rng.rand(b, h // 8, w // 8, 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2) * 220 + rng.rand(b, h, w, 3) * 20
    return np.clip(f, 0, 255).astype(np.uint8)


def write_clip(path, frames, fps=FPS):
    with RawVideoWriter(path, frames.shape[2], frames.shape[1], fps=fps) as w:
        w.write_batch(frames)
    return path


def read_pipe(path, reader_cls=FFmpegPipeReader):
    r = reader_cls(path)
    try:
        return r.read_batch(10_000)
    finally:
        r.close()


def frac_equal(a, b) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())


# -- the 7 plumbing cases of tests/test_ffmpeg_shim.py, port against JAX --------------

class TestPlumbing:
    def test_probe_matches_jax(self, shim, tmp_path, rng):
        clip = write_clip(tmp_path / "in.rawv", natural_frames(rng, 5))
        got = port_probe(clip)
        assert got == jprobe.probe(clip)
        assert got == {"width": W, "height": H, "fps": FPS, "frames": 5}

    def test_pipe_reader_batches_match_jax(self, shim, tmp_path, rng):
        frames = natural_frames(rng, 7)
        clip = write_clip(tmp_path / "in.rawv", frames)
        assert tffmpeg.have_ffmpeg()
        rt, rj = FFmpegPipeReader(clip), jffmpeg.FFmpegPipeReader(clip)
        try:
            for _ in range(3):
                a, b = rt.read_batch(3), rj.read_batch(3)
                np.testing.assert_array_equal(a, b)
                assert a.flags.c_contiguous and a.dtype == np.uint8
            assert rt.read_batch(3) is None and rj.read_batch(3) is None
        finally:
            rt.close()
            rj.close()
        np.testing.assert_array_equal(read_pipe(clip), frames)
        assert (rt.width, rt.height, rt.fps) == (rj.width, rj.height, rj.fps)

    def test_pipe_writer_roundtrip_matches_jax(self, shim, tmp_path, rng):
        frames = natural_frames(rng, 4)
        for cls, out in ((FFmpegPipeWriter, tmp_path / "port.mp4"),
                         (jffmpeg.FFmpegPipeWriter, tmp_path / "jax.mp4")):
            w = cls(out, W, H, fps=FPS)
            w.write_batch(frames[:2])
            w.write_batch(frames[2:])
            w.close()
        assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "jax.mp4").read_bytes()
        np.testing.assert_array_equal(read_pipe(tmp_path / "port.mp4"), frames)

    def test_segmenting_matches_jax(self, shim, tmp_path, rng):
        clip = write_clip(tmp_path / "in.rawv", natural_frames(rng, 13))
        for pkg, fn in (("port", tffmpeg.segment_video_ffmpeg),
                        ("jax", jffmpeg.segment_video_ffmpeg)):
            (tmp_path / pkg).mkdir()
            fn(clip, tmp_path / pkg / "seg_%03d.mp4", segment_duration=1.0)
        port, jax = sorted((tmp_path / "port").iterdir()), sorted((tmp_path / "jax").iterdir())
        assert [p.name for p in port] == [p.name for p in jax] == [
            "seg_000.mp4", "seg_001.mp4", "seg_002.mp4"]  # 6 + 6 + 1 frames
        assert all(a.read_bytes() == b.read_bytes() for a, b in zip(port, jax))
        assert port_probe(port[0])["frames"] == 6 and port_probe(port[2])["frames"] == 1

    def test_concat_matches_jax(self, shim, tmp_path, rng):
        a, b = natural_frames(rng, 3), natural_frames(rng, 2)
        parts = [write_clip(tmp_path / "a.rawv", a), write_clip(tmp_path / "b.rawv", b)]
        tffmpeg.concat_mp4_ffmpeg(parts, tmp_path / "port.mp4")
        jffmpeg.concat_mp4_ffmpeg(parts, tmp_path / "jax.mp4")
        assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "jax.mp4").read_bytes()
        np.testing.assert_array_equal(read_pipe(tmp_path / "port.mp4"), np.concatenate([a, b]))

    def test_hls_muxing_matches_jax(self, shim, tmp_path, rng):
        parts = [write_clip(tmp_path / "a.rawv", natural_frames(rng, 6)),
                 write_clip(tmp_path / "b.rawv", natural_frames(rng, 6))]
        outs = {}
        for pkg, fn in (("port", tffmpeg.segments_to_hls_ffmpeg),
                        ("jax", jffmpeg.segments_to_hls_ffmpeg)):
            (tmp_path / pkg).mkdir()
            master, playlist = fn(parts, tmp_path / pkg, segment_duration=1.0)
            assert Path(master).parent == Path(playlist).parent == tmp_path / pkg
            outs[pkg] = {p.name: p.read_bytes() for p in (tmp_path / pkg).iterdir()}
        assert outs["port"] == outs["jax"]
        assert sorted(n for n in outs["port"] if n.endswith(".m4s")) == [
            "segment_000.m4s", "segment_001.m4s"]
        text = outs["port"]["playlist.m3u8"].decode()
        assert "#EXTM3U" in text and "segment_000.m4s" in text and "#EXT-X-ENDLIST" in text
        assert "playlist.m3u8" in outs["port"]["master.m3u8"].decode()

    def test_m4s_remux_matches_jax(self, shim, tmp_path, rng):
        frames = natural_frames(rng, 3)
        marked = write_clip(tmp_path / "marked.rawv", frames)
        thls.mux_variant_to_m4s(marked, tmp_path / "port.m4s")
        jhls.mux_variant_to_m4s(marked, tmp_path / "jax.m4s")
        assert (tmp_path / "port.m4s").read_bytes() == (tmp_path / "jax.m4s").read_bytes()
        np.testing.assert_array_equal(read_pipe(tmp_path / "port.m4s"), frames)


# -- argv: every ffmpeg/ffprobe call, recorded without the shim ------------------------

PROBE_JSON = json.dumps({"streams": [{"codec_type": "video", "width": W, "height": H,
                                      "r_frame_rate": "6000/1000", "nb_frames": "12"}]})


class _FakeProc:
    def __init__(self):
        self.stdout, self.stdin, self.returncode = io.BytesIO(b""), io.BytesIO(), 0

    def wait(self):
        return 0

    def kill(self):
        pass


class _Recorder:
    """``subprocess.run``/``Popen`` stand-ins: each call's kind and argv, with
    a concat list's path replaced by its contents (the list is a temporary
    file of its own in each call), and a segmenter's output pattern in a
    private ``.ffmpeg-*`` directory (the port's ``segment_video``) moved to
    the directory the segments are renamed into."""

    def __init__(self):
        self.calls = []
        self.private_dirs = []

    def _record(self, kind, args):
        args = list(map(str, args))
        if "concat" in args:
            i = args.index("-i") + 1
            args[i] = "LIST:" + Path(args[i]).read_text()
        if "-segment_time" in args and Path(args[-1]).parent.name.startswith(".ffmpeg-"):
            out = Path(args[-1])
            self.private_dirs.append(out.parent)
            args[-1] = str(out.parent.parent / out.name)
        self.calls.append((kind, args))

    def run(self, args, **kw):
        self._record("run", args)
        return subprocess.CompletedProcess(args, 0, stdout=PROBE_JSON.encode(), stderr=b"")

    def popen(self, args, **kw):
        self._record("Popen", args)
        return _FakeProc()


def _drive(pkg, tmp: Path):
    """The same calls through one package's modules."""
    if pkg == "port":
        ff, pr, hls, seg, concat = (tffmpeg, port_probe, thls, tfp.segment_video,
                                    port_concatenate)
        marked_cls = MarkedSegment
    else:
        ff, pr, hls, seg, concat = (jffmpeg, jprobe.probe, jhls, jax_segment_video,
                                    jax_concatenate)
        from vfp_tpu.fingerprint.marker import MarkedSegment as marked_cls
    src, a, b = tmp / "src.rawv", tmp / "a.mp4", tmp / "b.mp4"
    pr(src)
    r = ff.FFmpegPipeReader(a)
    assert r.read_batch(4) is None
    r.close()
    for crf in (None, 23):
        w = ff.FFmpegPipeWriter(tmp / "out.mp4", W, H, FPS, crf=crf)
        w.write_batch(np.zeros((2, H, W, 3), np.uint8))
        w.close()
    ff.segment_video_ffmpeg(src, tmp / "seg_%03d.mp4", 1.0)
    ff.concat_mp4_ffmpeg([a, b], tmp / "cat.mp4")
    ff.segments_to_hls_ffmpeg([a, b], tmp, 1.0)
    hls.mux_variant_to_m4s(a, tmp / "a.m4s")
    seg(src, tmp / "segments", 1.0)
    concat([a, b], tmp / "leak.mp4")
    marked = [marked_cls(file=str(f), segment_number=i, copy_index=0)
              for i, f in enumerate((a, b))]
    hls.write_hls_playlists(marked, tmp / "hls", copies=1, segment_duration=1.0)


def test_argv_matches_jax(tmp_path, monkeypatch):
    write_clip(tmp_path / "src.rawv", np.zeros((2, H, W, 3), np.uint8))
    for mod in (jffmpeg, jprobe, tffmpeg, tprobe):
        monkeypatch.setattr(mod, "shutil", _which(True))
    _clear_caches()
    calls, private = {}, {}
    try:
        for pkg in ("port", "jax"):
            rec = _Recorder()
            with monkeypatch.context() as mp:
                mp.setattr(subprocess, "run", rec.run)
                mp.setattr(subprocess, "Popen", rec.popen)
                _drive(pkg, tmp_path)
            calls[pkg] = rec.calls
            private[pkg] = rec.private_dirs
    finally:
        _clear_caches()
    assert calls["port"] == calls["jax"]
    assert private["jax"] == [] and [d.parent for d in private["port"]] == [
        tmp_path / "segments"]
    assert not private["port"][0].exists()  # removed once its segments are renamed
    kinds = [(k, a[0]) for k, a in calls["port"]]
    assert kinds.count(("run", "ffprobe")) == 2  # probe and the pipe reader's
    assert kinds.count(("Popen", "ffmpeg")) == 3 and len(kinds) == 13, kinds


# -- dispatch: reader and writer classes with and without ffmpeg ------------------------

SUFFIXES = (".rawv", ".y4m", ".avi", ".mp4", ".m4s", ".mkv")
RAWV_READERS = (NativeRawVideoReader, RawVideoReader)
RAWV_WRITERS = (NativeRawVideoWriter, RawVideoWriter)
READERS = {
    True: {".rawv": RAWV_READERS, ".y4m": (Y4MReader,), ".avi": (FFmpegPipeReader,),
           ".mp4": (FFmpegPipeReader,), ".m4s": (FFmpegPipeReader,),
           ".mkv": (FFmpegPipeReader,)},
    False: {".rawv": RAWV_READERS, ".y4m": (Y4MReader,), ".avi": (MjpegAviReader,),
            ".mp4": (Mp4MjpegReader,), ".m4s": (Mp4MjpegReader,), ".mkv": ValueError},
}
WRITERS = {
    True: {".rawv": RAWV_WRITERS, ".y4m": (Y4MWriter,), ".avi": (MjpegAviWriter,),
           ".mp4": (FFmpegPipeWriter,), ".m4s": (FFmpegPipeWriter,),
           ".mkv": (FFmpegPipeWriter,)},
    False: {".rawv": RAWV_WRITERS, ".y4m": (Y4MWriter,), ".avi": (MjpegAviWriter,),
            ".mp4": ValueError, ".m4s": ValueError, ".mkv": ValueError},
}


def _source_file(path: Path, with_ffmpeg: bool, frames):
    """A file ``open_reader`` can open under that suffix on that route: the
    shim's VFPRAWV1 bytes for the pipe; the port's own containers without."""
    suffix = path.suffix
    if suffix == ".y4m":
        with Y4MWriter(path, W, H, FPS) as w:
            w.write_batch(frames)
    elif suffix == ".rawv" or with_ffmpeg:
        write_clip(path, frames)
    elif suffix == ".avi":
        with MjpegAviWriter(path, W, H, FPS) as w:
            w.write_batch(frames)
    elif suffix in (".mp4", ".m4s"):
        avi = path.with_suffix(".avi")
        _source_file(avi, False, frames)
        mp4 = path.with_suffix(".mp4")
        tmp4.write_mp4(mp4, [tmp4.track_from_mjpeg_avi(avi)])
        if suffix == ".m4s":
            tmp4.fragment_mp4(mp4, path)
    else:
        path.write_bytes(b"not read")


@pytest.fixture(params=[True, False], ids=["ffmpeg", "no_ffmpeg"])
def route(request, monkeypatch):
    if request.param:
        request.getfixturevalue("shim")
    else:
        request.getfixturevalue("no_ffmpeg")
    assert tffmpeg.have_ffmpeg() is request.param
    return request.param


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_reader_dispatch(route, suffix, tmp_path, rng):
    path = tmp_path / f"clip{suffix}"
    frames = natural_frames(rng, 2)
    _source_file(path, route, frames)
    want = READERS[route][suffix]
    if want is ValueError:
        with pytest.raises(ValueError, match="reads"):
            open_reader(path)
        return
    r = open_reader(path)
    try:
        assert isinstance(r, want), (type(r), want)
        got = r.read_batch(4)
    finally:
        r.close()
    assert got.shape == frames.shape
    if suffix == ".rawv" or (route and suffix != ".y4m"):
        np.testing.assert_array_equal(got, frames)  # exact containers and the shim


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_writer_dispatch(route, suffix, tmp_path, rng):
    path = tmp_path / f"out{suffix}"
    want = WRITERS[route][suffix]
    if want is ValueError:
        with pytest.raises(ValueError, match="writes frames to"):
            open_writer(path, W, H, FPS)
        assert not path.exists()
        return
    w = open_writer(path, W, H, FPS)
    try:
        assert isinstance(w, want), (type(w), want)
        w.write_batch(natural_frames(rng, 2))
    finally:
        w.close()
    assert path.stat().st_size > 0


# -- workflows: hls-mark, leak and trace on the ffmpeg route, port against JAX --------

@pytest.fixture
def workflows(shim, tmp_path):
    """Both packages' hls-mark on the same source under the shim."""
    frames = natural_frames(np.random.RandomState(7), N)
    src = write_clip(tmp_path / "src.rawv", frames)
    out = {}
    for pkg, fp, extra in (("port", tfp, CPU), ("jax", jfp, {})):
        base = tmp_path / pkg
        segs = fp.segment_video(src, base / "segments", 1.0)
        marked, payloads, copies = fp.mark_segments(segs, base / "marked_segments", copies=2,
                                                    batch_size=4, **extra)
        out[pkg] = {"base": base, "segs": segs, "marked": marked, "payloads": payloads,
                    "copies": copies}
    return frames, out


def test_hls_mark_workflow_matches_jax(workflows):
    frames, out = workflows
    port, jax = out["port"], out["jax"]
    assert [p.name for p in port["segs"]] == [p.name for p in jax["segs"]] == [
        "segment_000.mp4", "segment_001.mp4"]
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(port["segs"], jax["segs"]))
    assert not list((port["base"] / "segments").glob("*.audio.mp4"))  # no sidecars
    assert port["payloads"] == jax["payloads"] and port["copies"] == jax["copies"]
    assert [Path(m.file).name for m in port["marked"]] == [
        Path(m.file).name for m in jax["marked"]]
    assert all(m.file.endswith(".mp4") for m in port["marked"])
    for mp, mj in zip(port["marked"], jax["marked"]):
        a, b = read_pipe(mp.file), read_pipe(mj.file)
        assert frac_equal(a, b) >= 0.999, mp.file
    ok = [tfp.verify_segment(m.file, m.payload, **CPU)[2] for m in port["marked"]]
    assert ok == [True] * 4
    views = {}
    for pkg, fp in (("port", tfp), ("jax", jfp)):
        master, playlist, seg_map, variants = fp.write_hls_playlists(
            out[pkg]["marked"], out[pkg]["base"] / "hls", copies=2, segment_duration=1.0)
        views[pkg] = (Path(master).read_text(), Path(playlist).read_text(), seg_map, variants)
        assert len(list((out[pkg]["base"] / "hls").glob("*.m4s"))) == 4
    assert views["port"] == views["jax"]
    assert all(name.endswith(".m4s") for row in views["port"][3] for name in row)
    for name in (n for row in views["port"][3] for n in row):
        np.testing.assert_array_equal(read_pipe(port["base"] / "hls" / name),
                                      read_pipe(Path(port["marked"][0].file).parent /
                                                views["port"][2][name]))


def test_leak_and_trace_match_jax(workflows):
    _, out = workflows
    results = {}
    for pkg, fp, manifests, extra in (("port", tfp, write_manifests, CPU),
                                      ("jax", jfp, jax_write_manifests, {})):
        base = out[pkg]["base"]
        manifests(base, out[pkg]["payloads"], out[pkg]["copies"])
        leaked, info = fp.generate_leak(base / "segment_copies.json", pattern="10")
        assert leaked == base / "leaked_video.mp4"
        result = fp.trace_leak(leaked, base / "detection",
                               payload_file=base / "segment_payloads.json",
                               segment_duration=1.0, **extra)
        assert [Path(s.segment).suffix for s in result.segments] == [".mp4", ".mp4"]
        results[pkg] = (info, result.fingerprint, result.to_json(),
                        json.loads((base / "detection" / "detection_results.json").read_text()))
    assert results["port"] == results["jax"]
    assert results["port"][1] == results["port"][0]["pattern_string"] == "10"


def test_farm_workers_take_the_ffmpeg_route(workflows, tmp_path):
    """Spawned workers inherit PATH and resolve ``have_ffmpeg`` themselves:
    the farm writes the serial run's ``.mp4`` variants, byte for byte."""
    from vfp_tpu_torch.parallel import mark_segments_parallel

    _, out = workflows
    port = out["port"]
    marked, payloads, copies = mark_segments_parallel(
        port["segs"], tmp_path / "farm", copies=2, workers=2, batch_size=4,
        worker_device="cpu")
    assert payloads == port["payloads"] and copies == port["copies"]
    assert [Path(m.file).name for m in marked] == [Path(m.file).name for m in port["marked"]]
    for a, b in zip(marked, port["marked"]):
        assert Path(a.file).read_bytes() == Path(b.file).read_bytes(), a.file


def test_segments_are_renamed_into_place_not_rewritten(shim, tmp_path, rng):
    """ffmpeg segments into a private directory and each segment is renamed
    into place, so a reader of an earlier segment (another rank of
    ``hls-mark --distributed``) keeps the whole file it opened, and no
    private directory is left behind."""
    first = write_clip(tmp_path / "a.rawv", natural_frames(rng, 12))
    second = write_clip(tmp_path / "b.rawv", natural_frames(rng, 12))
    segs = tfp.segment_video(first, tmp_path / "segments", 1.0)
    before = segs[0].read_bytes()
    with open(segs[0], "rb") as held:
        again = tfp.segment_video(second, tmp_path / "segments", 1.0)
        assert held.read() == before
    assert again == segs and again[0].read_bytes() != before
    assert sorted(p.name for p in (tmp_path / "segments").iterdir()) == [
        "segment_000.mp4", "segment_001.mp4"]


def test_rerun_into_a_used_directory_returns_only_this_sources_segments(shim, tmp_path, rng):
    """Segments an earlier, longer source left behind are not this source's:
    ``segment_video`` and an ``hls-mark`` without ``--clean`` into the same
    output directory see only the new source's, and write what a fresh run
    writes."""
    long_src = write_clip(tmp_path / "long.rawv", natural_frames(rng, 24))
    short_src = write_clip(tmp_path / "short.rawv", natural_frames(rng, 12))
    assert len(tfp.segment_video(long_src, tmp_path / "segs", 1.0)) == 4
    assert [p.name for p in tfp.segment_video(short_src, tmp_path / "segs", 1.0)] == [
        "segment_000.mp4", "segment_001.mp4"]
    flags = ["--copies", "2", "--segment-duration", "1", "--batch-size", "4", "--device", "cpu"]
    _cli(["hls-mark", str(long_src), str(tmp_path / "reused"), *flags])
    text = _cli(["hls-mark", str(short_src), str(tmp_path / "reused"), *flags])
    assert "created 2 segments" in text and "All segments were watermarked" in text
    _cli(["hls-mark", str(short_src), str(tmp_path / "fresh"), *flags])
    for name in ("segment_payloads.json", "segment_copies.json", "segment_mapping.json",
                 "hls/master.m3u8"):
        assert ((tmp_path / "reused" / name).read_text()
                == (tmp_path / "fresh" / name).read_text()), name
    assert sorted(json.loads((tmp_path / "reused" / "segment_payloads.json").read_text())) == [
        "0_0", "0_1", "1_0", "1_1"]  # 2 segments x 2 copies


def test_cli_distributed_two_ranks_on_the_shim(shim, tmp_path, rng):
    """Two ranks of ``hls-mark --distributed`` segment with ffmpeg into one
    shared output dir and write what the serial CLI writes on the same
    route: the same manifests and playlists, the same ``.mp4`` variants byte
    for byte, and only ``segment_NNN.mp4`` in the segments directory."""
    from vfp_tpu_torch.parallel.mesh import free_port

    from torch_rank_worker import run_ranks

    src = str(write_clip(tmp_path / "src.rawv", natural_frames(rng, 24)))
    flags = ["--copies", "2", "--segment-duration", "1", "--batch-size", "4", "--device", "cpu"]
    _cli(["hls-mark", src, str(tmp_path / "serial"), *flags])
    argv = ["hls-mark", src, str(tmp_path / "dist"), *flags, "--distributed", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", "2"]
    results = run_ranks(2, [{"name": "cli", "kind": "cli", "argv": argv}], tmp_path / "out")
    rank0, rank1 = (r["cli"]["stdout"] for r in results)
    assert "All segments were watermarked successfully!" in rank0
    assert "rank 1: shard done" in rank1
    for name in ("segment_payloads.json", "segment_copies.json", "segment_mapping.json",
                 "hls/master.m3u8", "hls/playlist.m3u8"):
        assert ((tmp_path / "dist" / name).read_text()
                == (tmp_path / "serial" / name).read_text()), name
    assert sorted(p.name for p in (tmp_path / "dist" / "segments").iterdir()) == [
        f"segment_{i:03d}.mp4" for i in range(4)]
    variants = sorted((tmp_path / "serial" / "marked_segments").glob("*.mp4"))
    assert len(variants) == 8
    for f in variants:
        assert (tmp_path / "dist" / "marked_segments" / f.name).read_bytes() == f.read_bytes()


# -- the CLI, the service, failures, probe without ffprobe ---------------------------

def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_cli(argv)
    return buf.getvalue()


def test_cli_mark_to_mp4_then_detect(shim, tmp_path):
    frames = natural_frames(np.random.RandomState(3), 8)
    src = write_clip(tmp_path / "in.rawv", frames)
    flags = ["--batch-size", "4", "--device", "cpu"]
    assert "marked 8 frames" in _cli(["mark", str(src), str(tmp_path / "out.mp4"), *flags])
    _cli(["mark", str(src), str(tmp_path / "out.rawv"), *flags])
    text = _cli(["detect", str(tmp_path / "out.mp4"), "--payload", PAYLOAD, *flags])
    assert f"majority payload: {PAYLOAD} (frequency 1.00)" in text, text
    assert "matches expected payload: True" in text
    # the pipe writer carries the marked frames unchanged through the shim
    marked = RawVideoReader(tmp_path / "out.rawv")
    try:
        np.testing.assert_array_equal(read_pipe(tmp_path / "out.mp4"), marked.read_batch(8))
    finally:
        marked.close()


def test_service_upload_view_download(shim, tmp_path):
    frames = natural_frames(np.random.RandomState(4), N)
    src = write_clip(tmp_path / "src.rawv", frames)
    data_dir = tmp_path / "data"
    srv = tapp.make_server("127.0.0.1", 0, data_dir, device="cpu", num_copies=2,
                           segment_duration=1.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        body, headers = _multipart("file", "src.rawv", src.read_bytes())
        status, resp, _ = _req(base, "/upload", body, headers, "POST")
        assert status == 200, resp
        assert json.loads(resp)["total_variants"] == 4
        assert sorted(p.name for p in (data_dir / "segments").iterdir()) == [
            "segment_000.mp4", "segment_001.mp4"]
        status, resp, _ = _req(base, "/start-view", json.dumps({"username": "erin"}).encode(),
                               {"Content-Type": "application/json"}, "POST")
        view = json.loads(resp)
        status, m3u8, _ = _req(base, f"/view/{view['view_id']}")
        names = [line.rsplit("/", 1)[1] for line in m3u8.decode().splitlines()
                 if line.startswith("/hls/")]
        assert len(names) == 2 and all(n.endswith(".m4s") for n in names)
        status, data, headers = _req(base, f"/download-view/{view['view_id']}")
        assert status == 200 and headers["Content-Type"] == "video/mp4"
        assert headers["Content-Disposition"] == (
            f'attachment; filename="view_{view["view_id"]}.mp4"')
        spliced = tmp_path / "download.mp4"
        spliced.write_bytes(data)
        np.testing.assert_array_equal(
            read_pipe(spliced),
            np.concatenate([read_pipe(data_dir / "hls" / n) for n in names]))
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture
def failing_ffmpeg(monkeypatch, tmp_path):
    """An ``ffmpeg`` that reads and writes nothing and exits 3, beside the
    shim's ffprobe."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "ffmpeg").write_text("#!/bin/sh\nexit 3\n")
    (bin_dir / "ffmpeg").chmod(0o755)
    (bin_dir / "ffprobe").symlink_to(SHIM_DIR / "ffprobe")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    _clear_caches()
    yield
    _clear_caches()


def test_failing_child_raises_at_reader_close(failing_ffmpeg, tmp_path, rng):
    clip = write_clip(tmp_path / "in.rawv", natural_frames(rng, 2))
    r = FFmpegPipeReader(clip)
    assert r.read_batch(2) is None
    with pytest.raises(IOError, match="exited with code 3"):
        r.close()


def test_failing_child_after_the_last_frame_raises_at_close(monkeypatch, tmp_path, rng):
    """A child that sends every frame and then fails: a caller that reads
    the last frame and closes without reading to the end still gets the
    IOError."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "ffmpeg").write_text(f"#!/bin/sh\nhead -c {H * W * 3} /dev/zero\nexit 3\n")
    (bin_dir / "ffmpeg").chmod(0o755)
    (bin_dir / "ffprobe").symlink_to(SHIM_DIR / "ffprobe")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    _clear_caches()
    try:
        r = FFmpegPipeReader(write_clip(tmp_path / "in.rawv", natural_frames(rng, 1)))
        assert r.read_batch(1).shape == (1, H, W, 3)
        r.proc.wait(timeout=30)  # the child has gone; the reader has not seen the end
        with pytest.raises(IOError, match="exited with code 3"):
            r.close()
    finally:
        _clear_caches()


def test_failing_child_raises_at_writer_close(failing_ffmpeg, tmp_path, rng):
    w = FFmpegPipeWriter(tmp_path / "out.mp4", W, H, FPS)
    with pytest.raises(OSError) as err:  # the pipe's BrokenPipeError, or IOError at close
        try:
            w.write_batch(natural_frames(rng, 1))
        finally:
            w.close()
    assert isinstance(err.value, BrokenPipeError) or "exited with code 3" in str(err.value)
    assert w.proc.returncode == 3


def test_reader_closed_early_stops_its_child(shim, tmp_path, rng):
    clip = write_clip(tmp_path / "in.rawv", natural_frames(rng, 6))
    r = FFmpegPipeReader(clip)
    assert len(r.read_batch(1)) == 1
    r.close()  # no error: the child's exit is the close's doing
    assert r.proc.returncode is not None


def test_probe_without_ffprobe_reads_the_ports_containers(no_ffmpeg, tmp_path, rng):
    frames = natural_frames(rng, 3)
    for suffix in (".rawv", ".avi", ".mp4", ".m4s"):
        path = tmp_path / f"clip{suffix}"
        _source_file(path, False, frames)
        assert port_probe(path) == {"width": W, "height": H, "fps": FPS, "frames": 3}, suffix
    _source_file(tmp_path / "clip.y4m", False, frames)
    assert port_probe(tmp_path / "clip.y4m") == {"width": W, "height": H, "fps": FPS}
    (tmp_path / "clip.mkv").write_bytes(b"not a video")
    with pytest.raises(IOError, match="reads"):
        port_probe(tmp_path / "clip.mkv")


def test_probe_failure_is_an_ioerror(shim, tmp_path):
    (tmp_path / "bad.mp4").write_bytes(b"not rawv")
    with pytest.raises(IOError, match="ffprobe"):
        port_probe(tmp_path / "bad.mp4")


def test_mjpeg_avi_holds_rgb_for_an_rgb24_decoder(tmp_path):
    """``MjpegAviWriter`` takes frames in file order (RGB) and stores a JPEG
    of those colours, so a decoder that outputs rgb24 (ffmpeg's pipe) gives
    the file order back, as the port's own reader does: cv2.imdecode's BGR,
    reversed, is within JPEG loss of the frame and far from its R/B swap."""
    frames = np.empty((1, H, W, 3), np.uint8)
    frames[:] = (230, 40, 20)  # flat red: a swap cannot hide in the JPEG loss
    with MjpegAviWriter(tmp_path / "c.avi", W, H, FPS, 95) as w:
        w.write_batch(frames)
    chunk = next(iter_video_chunks(tmp_path / "c.avi"))
    rgb = cv2.imdecode(np.frombuffer(chunk, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    err = np.abs(rgb.astype(int) - frames[0]).mean()
    swapped = np.abs(rgb[..., ::-1].astype(int) - frames[0]).mean()
    assert err < 3 and swapped > 50, (err, swapped)
    r = MjpegAviReader(tmp_path / "c.avi")
    try:
        np.testing.assert_array_equal(r.read_batch(1)[0], rgb)
    finally:
        r.close()


# -- durability: the JAX package's ffmpeg channel ---------------------------------------

class _PassThrough(_Recorder):
    """``_Recorder`` that also runs each call, with the real ``subprocess``
    functions (the shim answers them)."""

    def __init__(self, run, popen):
        super().__init__()
        self._run, self._popen = run, popen

    def run(self, args, **kw):
        self._record("run", args)
        return self._run(args, **kw)

    def popen(self, args, **kw):
        self._record("Popen", args)
        return self._popen(args, **kw)


def _durability_run(fn, src, out, container, monkeypatch, **kw):
    """(every ffmpeg/ffprobe argv with ``out`` written OUT, the report with
    its paths relative to ``out`` and without wall_seconds)."""
    rec = _PassThrough(subprocess.run, subprocess.Popen)
    with monkeypatch.context() as mp:
        mp.setattr(subprocess, "run", rec.run)
        mp.setattr(subprocess, "Popen", rec.popen)
        report = fn(src, out, segment_duration=1.0, batch_size=4, container=container, **kw)
    argv = [(k, [a.replace(str(out), "OUT") for a in args]) for k, args in rec.calls]
    report = json.loads(json.dumps(report).replace(str(out), "OUT"))
    report.pop("wall_seconds")
    return argv, report


@pytest.mark.parametrize("container", [None, "mp4"])
def test_durability_takes_the_jax_ffmpeg_route(shim, tmp_path, rng, monkeypatch, container):
    """With ffmpeg on PATH the port's durability experiment segments through
    ffmpeg, marks into ``.mp4`` through the pipe writer, splices ``full.mp4``
    with ffmpeg's concat and re-segments it, as ``vfp_tpu.workflows.durability``
    does: every ffmpeg/ffprobe argv and the report (wall seconds aside) equal.
    The shim copies frames, so this proves the plumbing, not a codec's loss."""
    from vfp_tpu.workflows import durability as jdur
    from vfp_tpu_torch.workflows import durability as tdur

    src = write_clip(tmp_path / "src.rawv", natural_frames(rng, N))
    argv, report = _durability_run(tdur.run_durability, src, tmp_path / "port", container,
                                   monkeypatch, **CPU)
    jargv, jreport = _durability_run(jdur.run_durability, src, tmp_path / "jax", container,
                                     monkeypatch)
    assert argv == jargv
    assert report == jreport
    assert report["is_successful"] and report["segment_pairs"] == 2
    assert [r["segment"] for r in report["reencoded_results"]] == [
        f"OUT/resegmented/segment_{i:03d}.mp4" for i in range(2)]
    assert sorted(p.name for p in (tmp_path / "port" / "marked_segments").iterdir()) == [
        "marked_segment_000.mp4", "marked_segment_001.mp4"]
    assert (tmp_path / "port" / "full.mp4").exists()
    kinds = [(k, a[0], "concat" in a, "-segment_time" in a) for k, a in argv]
    assert kinds.count(("run", "ffmpeg", False, True)) == 2  # segment, re-segment
    assert kinds.count(("run", "ffmpeg", True, False)) == 1  # the splice
    assert sum(k == "Popen" and "-s" in a for k, a in argv) == 2  # a pipe writer a segment


def test_durability_cli_accepts_mp4_with_ffmpeg(shim, tmp_path, rng, capsys):
    src = write_clip(tmp_path / "src.rawv", natural_frames(rng, N))
    with pytest.raises(SystemExit) as e:  # exit 0: the report's verdict
        port_cli(["durability", str(src), str(tmp_path / "d"), "--container", "mp4",
                  "--segment-duration", "1", "--device", "cpu"])
    assert e.value.code == 0
    report = json.loads(capsys.readouterr().out)
    assert report["is_successful"] and report["original_total"] == 2
    assert (tmp_path / "d" / "full.mp4").exists()
