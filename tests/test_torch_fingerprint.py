"""vfp_tpu_torch.fingerprint and its CLI against vfp_tpu, on the CPU.

The JAX tests' sizes: 18 frames of 64x96 at 6 fps (2 s segments: 12 + 6
frames), 3 copies, batch 8 and, for cross-file packing, 4.  The JAX marker
runs on the port's ``.rawv`` segments with ``out_ext=".rawv"`` and the
full-frame path (VFP_LOWLINK=0).  Stated tolerance: marked variant files
identical on >= 99.9% of pixels each (the documented ±1 class of
``test_multi_marker_matches_jax``); manifests, playlists, payloads,
patterns, frequencies, successes and fingerprints exactly equal.
"""

import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from vfp_tpu import fingerprint as jfp
from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.fingerprint import marker as jmarker
from vfp_tpu.wm import DctQim as JaxDctQim, DwtDctSvd as JaxCodec
from vfp_tpu_torch import fingerprint as tfp
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.fingerprint import marker as tmarker
from vfp_tpu_torch.io import RAWV_MAGIC, RawVideoReader, RawVideoWriter
from vfp_tpu_torch.wm import DctQim, DwtDctSvd, Shuffler

from torch_parity import natural_frames

torch.set_num_threads(1)
H, W, FPS, N = 64, 96, 6, 18
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def full_frame_jax_path(monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(10_000)
    finally:
        r.close()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    p = tmp_path_factory.mktemp("fpsrc") / "source.rawv"
    frames = natural_frames(np.random.RandomState(42), N, H, W)
    with RawVideoWriter(p, W, H, fps=FPS) as w:
        w.write_batch(frames)
    return p, frames


@pytest.fixture(scope="module")
def trees(source, tmp_path_factory):
    """The port's segments, marked by the port and by the JAX package."""
    import os

    os.environ["VFP_LOWLINK"] = "0"  # module scope: the autouse fixture comes later
    base = tmp_path_factory.mktemp("fptrees")
    segs = tfp.segment_video(source[0], base / "segments", 2.0)
    out = {}
    for name, fp, kw in (("port", tfp, CPU), ("jax", jfp, {"out_ext": ".rawv"})):
        root = base / name
        marked, payloads, copies = fp.mark_segments(
            segs, root / "marked_segments", copies=3, batch_size=8, **kw)
        fp.write_manifests(root, payloads, copies)
        out[name] = (root, marked, payloads, copies)
    return segs, out


def test_payload_codec_matches_jax():
    for seg in range(20):
        for c in range(18):
            want = jfp.payload_for_segment(seg, c)
            np.testing.assert_array_equal(tfp.payload_for_segment(seg, c), want)
            assert tfp.decode_segment_copy(want) == jfp.decode_segment_copy(want)
    assert tfp.decode_segment_copy(None) == jfp.decode_segment_copy(None) == (None, None)
    assert tfp.decode_segment_copy([1, 0]) == jfp.decode_segment_copy([1, 0])
    for seq in ([0, 1, 2], [2, None, 1], [], [9, 10]):
        assert tfp.pattern_string(seq) == jfp.pattern_string(seq)


@pytest.mark.parametrize("copies,segments", [(3, 4), (2, 3), (5, 1), (10, 2)])
def test_pattern_for_view_matches_jax_with_overflow(copies, segments):
    for view in range(0, copies ** segments * 3 + 2):  # past copies**segments: overflow
        assert (tfp.pattern_for_view(view, copies, segments)
                == jfp.pattern_for_view(view, copies, segments))


def test_pattern_for_view_with_one_copy_is_all_zeros():
    """The JAX function never returns for one copy and a view above 0
    (v // 1 never reaches 0); the port gives the only pattern there is."""
    assert tfp.pattern_for_view(0, 1, 3) == jfp.pattern_for_view(0, 1, 3) == [0, 0, 0]
    assert tfp.pattern_for_view(7, 1, 3) == [0, 0, 0]
    with pytest.raises(ValueError):
        tfp.pattern_for_view(7, 0, 3)


def test_view_playlist_text_matches_jax():
    files = [[f"marked_seg{s:03d}_copy{c}.rawv" for c in range(3)] for s in range(4)]
    for view in (0, 5, 26, 80, 200):
        for kw in ({}, {"uri_prefix": "/hls/", "segment_duration": 6.0},
                   {"init_uri": "init.mp4"}):
            assert (tfp.view_playlist(view, 3, files, **kw)
                    == jfp.view_playlist(view, 3, files, **kw))


def test_segment_grid_is_exact_and_matches_jax(source, tmp_path):
    path, frames = source
    segs = tfp.segment_video(path, tmp_path / "port", 2.0)
    assert [p.name for p in segs] == ["segment_000.rawv", "segment_001.rawv"]
    got = [_read(p) for p in segs]
    assert [len(g) for g in got] == [12, 6]
    np.testing.assert_array_equal(got[0], frames[:12])
    np.testing.assert_array_equal(got[1], frames[12:])
    jsegs = jfp.segment_video(path, tmp_path / "jax", 2.0)  # the JAX one writes .avi
    assert [p.stem for p in jsegs] == [p.stem for p in segs]
    assert tfp.frames_per_segment(29.97, 2.0) == jfp.frames_per_segment(29.97, 2.0) == 60
    with pytest.raises(ValueError, match=".rawv"):
        tfp.segment_video(tmp_path / "in.mkv", tmp_path / "x", 2.0)


def test_manifests_match_jax(trees):
    segs, out = trees
    (proot, pmarked, ppay, pcop), (jroot, jmarked, jpay, jcop) = out["port"], out["jax"]
    assert ppay == jpay and pcop == jcop
    assert pcop["total_marked_segments"] == 6 and pcop["copies_per_segment"] == 3
    for name in ("segment_payloads.json", "segment_copies.json"):
        assert (proot / name).read_text() == (jroot / name).read_text()
    assert ([(m.segment_number, m.copy_index, m.payload) for m in pmarked]
            == [(m.segment_number, m.copy_index, m.payload) for m in jmarked])


def test_marked_variants_match_jax(trees):
    segs, out = trees
    for pm, jm in zip(out["port"][1], out["jax"][1]):
        a, b = _read(pm.file), _read(jm.file)
        assert a.shape == b.shape == (12 if pm.segment_number == 0 else 6, H, W, 3)
        assert (a == b).mean() >= 0.999, pm.file


def test_playlists_and_segment_map_match_jax(trees, tmp_path):
    segs, out = trees
    res = {}
    for name, fp in (("port", tfp), ("jax", jfp)):
        master, playlist, seg_map, variants = fp.write_hls_playlists(
            out[name][1], tmp_path / name, copies=3)
        res[name] = (master.read_text(), playlist.read_text(), seg_map, variants,
                     sorted(p.name for p in (tmp_path / name).iterdir()))
    assert res["port"] == res["jax"]
    assert res["port"][3] == [[f"marked_seg{s:03d}_copy{c}.rawv" for c in range(3)]
                              for s in range(2)]
    for pm in out["port"][1]:  # the HLS copies are the marked files byte for byte
        name = f"marked_seg{pm.segment_number:03d}_copy{pm.copy_index}.rawv"
        assert (tmp_path / "port" / name).read_bytes() == open(pm.file, "rb").read()


@pytest.mark.parametrize("kw", [{"pattern": "21"}, {"random_seed": 7}],
                         ids=["pattern", "seeded"])
def test_leak_info_matches_jax(trees, kw):
    segs, out = trees
    info = {}
    for name, fp in (("port", tfp), ("jax", jfp)):
        root = out[name][0]
        leaked, info[name] = fp.generate_leak(root / "segment_copies.json", **kw)
        assert leaked == root / "leaked_video.rawv"
        assert json.loads((root / "leak_info.json").read_text()) == info[name]
    assert info["port"] == info["jax"]
    pieces = [_read(out["port"][0] / "marked_segments" / f)
              for f in info["port"]["selected_segments"]]
    np.testing.assert_array_equal(_read(out["port"][0] / "leaked_video.rawv"),
                                  np.concatenate(pieces))


@pytest.mark.parametrize("batch_size,depth", [(8, 3), (4, 2), (4, 0)])
def test_segment_majorities_and_verify_match_jax(trees, batch_size, depth):
    """Batch 4 < the frames of a segment: frames are packed across files."""
    segs, out = trees
    marked = out["port"][1]
    files = [m.file for m in marked]
    got = tmarker.segment_majorities(files, 8, batch_size=batch_size, depth=depth, **CPU)
    want = jmarker.segment_majorities(files, 8, codec=JaxCodec(), batch_size=batch_size,
                                      depth=depth)
    assert len(got) == len(want) == 6
    for (gp, gf), (wp, wf), m in zip(got, want, marked):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gp, m.payload)
        assert gf == wf == 1.0
    vgot = tmarker.verify_segments(marked, batch_size=batch_size, depth=depth, **CPU)
    vwant = jmarker.verify_segments([(m.file, m.payload) for m in marked], codec=JaxCodec(),
                                    batch_size=batch_size, depth=depth)
    assert [(p.tolist(), f, ok) for p, f, ok in vgot] == [(p.tolist(), f, ok)
                                                          for p, f, ok in vwant]
    assert all(ok for _, _, ok in vgot)
    for m, (p, f, ok) in zip(marked[:3], vgot):  # the serial verify: the same votes
        sp, sf, sok = tfp.verify_segment(m.file, m.payload, batch_size=batch_size, **CPU)
        np.testing.assert_array_equal(sp, p)
        assert (sf, sok) == (f, ok)


def _marked_file(path, h, w, payload, rng, n=5):
    codec = DwtDctSvd()
    wm = Shuffler(key=0).generate_wm(payload, codec.wm_capacity((h, w, 3)))
    frames = np.clip(rng.rand(n, h, w, 3) * 220 + 20, 0, 255).astype(np.uint8)
    marked = codec.mark_frames(torch.from_numpy(frames),
                               torch.as_tensor(np.asarray(wm, np.float32).reshape(-1))).numpy()
    with RawVideoWriter(path, w, h, fps=FPS) as wtr:
        wtr.write_batch(marked)
    return str(path)


def test_segment_majorities_mixed_dims_match_jax(tmp_path, rng):
    """Packing flushes at a dim change; per-file votes stay exact."""
    dims = [(64, 96), (80, 112), (64, 96)]
    files = [_marked_file(tmp_path / f"seg{i}.rawv", h, w, tfp.payload_for_segment(i, 0), rng)
             for i, (h, w) in enumerate(dims)]
    got = tmarker.segment_majorities(files, 8, batch_size=8, **CPU)
    want = jmarker.segment_majorities(files, 8, codec=JaxCodec(), batch_size=8)
    for i, ((gp, gf), (wp, wf)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gp, tfp.payload_for_segment(i, 0))
        assert gf == wf == 1.0


def test_corrupt_rawv_votes_none_as_jax(tmp_path, rng):
    trunc = tmp_path / "trunc.rawv"
    trunc.write_bytes(RAWV_MAGIC + b"\x00\x01")  # < 24-byte header
    dims = tmp_path / "dims.rawv"
    dims.write_bytes(RAWV_MAGIC + struct.pack("<IIII", 0, 0, 6, 1))
    empty = tmp_path / "empty.rawv"
    empty.write_bytes(RAWV_MAGIC + struct.pack("<IIII", W, H, 6, 1))
    for bad in (trunc, dims, empty):
        with pytest.raises(IOError):
            tmarker._read_all(bad)
        with pytest.raises(IOError):
            jmarker._read_all(bad)
    for name in ("seg.mkv", "seg"):  # the containers the port does not read
        with pytest.raises(ValueError, match=".rawv"):
            tmarker._read_all(tmp_path / name)
    frames = natural_frames(rng, 3, H, W)  # an MJPEG .avi segment is read
    with tmarker.open_writer(tmp_path / "seg.avi", W, H, FPS, 95) as w:
        w.write_batch(frames)
    got, fps = tmarker._read_all(tmp_path / "seg.avi")
    assert got.shape == frames.shape and fps == FPS
    import cv2  # each frame as cv2 codes it: one JPEG generation at q95

    for g, f in zip(got, frames):
        ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, 95])
        np.testing.assert_array_equal(g, cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1])
    for bad in (tmp_path / "missing.avi", trunc.with_suffix(".avi")):
        if bad.name != "missing.avi":
            bad.write_bytes(b"RIFF" + bytes(4) + b"AVI ")
        with pytest.raises(IOError):
            tmarker._read_all(bad)
    good = _marked_file(tmp_path / "good.rawv", H, W, tfp.payload_for_segment(0, 0), rng, 4)
    files = [str(trunc), good, str(dims), str(empty)]
    got = tmarker.segment_majorities(files, 8, batch_size=8, **CPU)
    want = jmarker.segment_majorities(files, 8, codec=JaxCodec(), batch_size=8)
    assert got[0] == want[0] == (None, 0.0) and got[2] == want[2] == (None, 0.0)
    assert got[3] == want[3] == (None, 0.0)
    np.testing.assert_array_equal(got[1][0], want[1][0])
    np.testing.assert_array_equal(got[1][0], tfp.payload_for_segment(0, 0))


@pytest.mark.parametrize("manifests", [True, False], ids=["manifests", "blind"])
def test_trace_matches_jax(trees, tmp_path, manifests):
    segs, out = trees
    res = {}
    for name, fp in (("port", tfp), ("jax", jfp)):
        root = out[name][0]
        leaked, _ = fp.generate_leak(root / "segment_copies.json",
                                     output_file=tmp_path / f"{name}_leak.rawv", pattern="12")
        payload_file = root / "segment_payloads.json" if manifests else None
        kw = CPU if name == "port" else {}
        res[name] = fp.trace_leak(leaked, tmp_path / f"{name}_det", payload_file,
                                  max_copies=3, **kw)
    got, want = res["port"], res["jax"]
    assert got.fingerprint == want.fingerprint == "12"
    assert got.success_rate == want.success_rate == 1.0
    assert ([(s.detected_copy_index, s.success) for s in got.segments]
            == [(s.detected_copy_index, s.success) for s in want.segments])
    on_disk = json.loads((tmp_path / "port_det" / "detection_results.json").read_text())
    assert on_disk == got.to_json()
    assert [r.keys() for r in on_disk] == [r.keys() for r in want.to_json()]


def test_custom_hls_bundle_matches_jax(trees, tmp_path):
    segs, out = trees
    got = {}
    for name, fp in (("port", tfp), ("jax", jfp)):
        root = tmp_path / name
        shutil.copytree(out[name][0], root)
        marked = [type(m)(str(root / "marked_segments" / Path(m.file).name), m.segment_number,
                          m.copy_index, m.payload) for m in out[name][1]]
        fp.write_hls_playlists(marked, root / "hls", copies=3)
        _, info = fp.generate_leak(root / "segment_copies.json", pattern="10", create_hls=True)
        hls = root / "hls"
        got[name] = (info["custom_hls_playlist"],
                     (hls / "custom_playlist_10.m3u8").read_text(),
                     (hls / "custom_master_10.m3u8").read_text(),
                     (hls / "cors_server.py").read_text(), (hls / "index.html").read_text())
    assert got["port"] == got["jax"]
    assert "seg000_copy1" in got["port"][1] and "seg001_copy0" in got["port"][1]


def test_writer_failure_unlinks_and_resume_remarks(source, tmp_path, monkeypatch):
    """A writer error leaves no partial file; resume=True re-marks it."""
    segs = tfp.segment_video(source[0], tmp_path / "segs", 1.0)
    assert len(segs) == 3
    real_open_writer = tmarker.open_writer

    class FailingWriter:
        def __init__(self, inner):
            self.inner = inner

        def write_batch(self, frames):
            raise IOError("disk full (injected)")

        def close(self):
            self.inner.close()

    def patched(file, *a, **k):
        w = real_open_writer(file, *a, **k)
        return FailingWriter(w) if "seg1" in str(file) else w

    monkeypatch.setattr(tmarker, "open_writer", patched)
    with pytest.raises(IOError, match="injected"):
        tfp.mark_segments(segs, tmp_path / "marked", copies=1, batch_size=8, **CPU)
    monkeypatch.setattr(tmarker, "open_writer", real_open_writer)
    assert (tmp_path / "marked" / "marked_seg0_copy0.rawv").exists()
    assert not (tmp_path / "marked" / "marked_seg1_copy0.rawv").exists()

    stats: dict = {}
    marked, _, _ = tfp.mark_segments(segs, tmp_path / "marked", copies=1, batch_size=8,
                                     resume=True, stats=stats, **CPU)
    assert len(marked) == 3
    assert all(ok for _, _, ok in tmarker.verify_segments(marked, **CPU))
    assert set(stats) == {"wall_seconds", "stage_seconds", "host_busy_seconds"}
    assert set(stats["stage_seconds"]) == {"decode", "device_full", "encode_write",
                                           "decode_wait", "queue_wait", "writer_idle"}


def test_a_submit_failure_unlinks_the_open_segment(source, tmp_path, monkeypatch):
    """A failure on the submitting side (a launch, say) also leaves no
    partial file behind, and is the error raised."""
    segs = tfp.segment_video(source[0], tmp_path / "segs", 1.0)
    real = tmarker.MultiMarker.submit
    calls = []

    def failing(self, frames):
        calls.append(len(frames))
        if len(calls) == 2:  # the second segment's batch
            raise RuntimeError("launch failed (injected)")
        return real(self, frames)

    monkeypatch.setattr(tmarker.MultiMarker, "submit", failing)
    with pytest.raises(RuntimeError, match="injected"):
        tfp.mark_segments(segs, tmp_path / "marked", copies=2, batch_size=8, **CPU)
    assert not list((tmp_path / "marked").glob("marked_seg1_*"))


def test_dct_qim_segments_match_jax(trees, tmp_path):
    segs, _ = trees
    res = {}
    for name, fp, codec, kw in (("port", tfp, DctQim(), CPU),
                                ("jax", jfp, JaxDctQim(), {"out_ext": ".rawv"})):
        marked, payloads, copies = fp.mark_segments(
            segs, tmp_path / name, copies=2, codec=codec, batch_size=8, **kw)
        kw = CPU if name == "port" else {}
        verified = fp.marker.verify_segments(marked, codec=codec, batch_size=4, **kw)
        res[name] = (marked, payloads, copies, [(p.tolist(), f, ok) for p, f, ok in verified])
    assert res["port"][1:] == res["jax"][1:]
    assert all(ok for _, _, ok in res["port"][3])
    for pm, jm in zip(res["port"][0], res["jax"][0]):
        assert (_read(pm.file) == _read(jm.file)).mean() >= 0.999


def _result_lines(text):
    keep = ("created ", "All segments", "Failed to properly", "pattern: ", "Success rate",
            "Copy fingerprint", "Copy sequence", "Total segments")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_cli_workflow_prints_the_jax_cli_lines(source, tmp_path, capsys):
    lines = {}
    for name, cli, flags in (("port", port_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        out = tmp_path / name
        cli(["hls-mark", str(source[0]), str(out), "--copies", "3", "--batch-size", "8",
             *flags])
        cli(["leak", str(out / "segment_copies.json"), "--pattern", "21", *flags])
        leaked = next(out.glob("leaked_video.*"))
        cli(["trace", str(leaked), str(out / "det"), "--payload-file",
             str(out / "segment_payloads.json"), *flags])
        lines[name] = _result_lines(capsys.readouterr().out)
    assert lines["port"] == lines["jax"]
    for want in ("created 2 segments", "All segments were watermarked successfully!",
                 "pattern: 21", "Success rate: 100.00%", "Copy fingerprint: 21"):
        assert want in lines["port"], (want, lines["port"])
    assert (tmp_path / "port" / "leaked_video.rawv").exists()
    mapping = json.loads((tmp_path / "port" / "segment_mapping.json").read_text())
    assert len(mapping["hls_to_watermarked"]) == 6


def test_cli_leak_detect_traces_on_the_given_device(source, tmp_path, capsys):
    out = tmp_path / "o"
    port_cli(["hls-mark", str(source[0]), str(out), "--copies", "2", "--device", "cpu"])
    port_cli(["leak", str(out / "segment_copies.json"), "--pattern", "10", "--detect",
              "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Copy fingerprint: 10" in text and "Success rate: 100.00%" in text
    assert (out / "detection" / "detection_results.json").exists()


@pytest.mark.parametrize("cmd", ["hls-mark", "leak", "trace"])
def test_cli_workflow_never_drops_to_the_cpu(cmd, source, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"hls-mark": ["hls-mark", str(source[0]), str(tmp_path / "o")],
            "leak": ["leak", str(tmp_path / "segment_copies.json"), "--pattern", "0"],
            "trace": ["trace", str(source[0]), str(tmp_path / "det")]}[cmd]
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(argv)  # default: cuda
    assert not (tmp_path / "o").exists() and not (tmp_path / "det").exists()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tfp.mark_segments([], tmp_path / "m")  # the library's default too


def test_cli_workflow_refuses_other_containers(tmp_path):
    src = tmp_path / "in.mkv"
    src.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match=".rawv"):
        port_cli(["hls-mark", str(src), str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(ValueError, match=".rawv"):
        port_cli(["trace", str(src), str(tmp_path / "det"), "--device", "cpu"])
    garbage = tmp_path / "in.mp4"  # a container the port reads, but not an MP4
    garbage.write_bytes(b"\x00" * 64)
    with pytest.raises(IOError, match="no moov"):
        port_cli(["hls-mark", str(garbage), str(tmp_path / "o"), "--device", "cpu"])
