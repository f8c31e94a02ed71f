"""The port's media layer end to end against the JAX package's no-ffmpeg run,
on the CPU: segment -> mark -> HLS -> leak -> trace on an MJPEG ``.mp4``
with an audio track and on a ``.y4m``, the service on such an upload, the
CLI on ``.y4m`` and ``.mp4`` inputs, ``--wm-image`` against cv2, the farm on
``.avi`` segments with sidecars, and the refusals (non-JPEG MP4 video,
``durability --container mp4``).

Source: 18 blurred-noise frames of 96x128 at 6 fps (``test_dwt_dct_svd``'s
content, which a q95 JPEG leaves marked), JPEG-coded by the port into an
MJPEG ``.avi`` and remuxed with 3 s of synthetic AAC-sized audio (seeded
bytes) into an ``.mp4`` by ``io/mp4.py``; 1 s segments, three of 6 frames.
The JAX package runs with ``have_ffmpeg`` patched False and ``Cv2Reader``
patched to read ``.avi``/``.mp4`` JPEG samples with ``cv2.imdecode`` (the
pattern of ``test_torch_durability.py``; no JAX file changes), on its
full-frame path (VFP_LOWLINK=0).  Stated tolerance: the workflow trees
(segments, sidecars, variants, HLS dir, manifests, leak, trace results) and
the service's files are byte-equal; the CLI's marked files equal on >= 99.9%
of pixels (the ±1 class of ``test_torch_fingerprint.py``) with equal
decisions; images equal to cv2's exactly.
"""

import contextlib
import io
import json
import urllib.error
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import vfp_tpu.fingerprint.hls as jhls
import vfp_tpu.fingerprint.leak as jleak
import vfp_tpu.fingerprint.segmenter as jsegmenter
import vfp_tpu.io.ffmpeg as jffmpeg
import vfp_tpu.io.mp4 as jmp4
import vfp_tpu.io.readers as jreaders
from vfp_tpu import fingerprint as jfp
from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.io.avi import avi_meta, iter_video_chunks
from vfp_tpu.serve import service as jservice
from vfp_tpu_torch import fingerprint as tfp
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import MjpegAviWriter, RawVideoReader, Y4MWriter, ffmpeg as tffmpeg, mp4 as tmp4
from vfp_tpu_torch.io.images import read_image_gray, write_png
from vfp_tpu_torch.native.jpeg import encode_jpeg
from vfp_tpu_torch.parallel import mark_segments_distributed, mark_segments_parallel
from vfp_tpu_torch.parallel import farm as tfarm
from vfp_tpu_torch.parallel.mesh import free_port
from vfp_tpu_torch.serve import VfpService
from vfp_tpu_torch.serve import app as tapp

import chip_smoke
from chip_smoke import audio_payloads, audio_track, sample_bytes
from test_dwt_dct_svd import natural_frames as blurred_frames
from test_torch_serve import _multipart, _req, _status
from torch_rank_worker import run_ranks

torch.set_num_threads(1)
H, W, FPS, N = 96, 128, 6, 18
CPU = {"device": "cpu"}
PAYLOAD = "01100101"


class ImdecodeReader(jreaders.FrameReader):
    """The JAX reader protocol over ``cv2.imdecode`` of each JPEG sample of an
    MJPEG ``.avi`` or ``.mp4``/``.m4s`` (the JAX ``Cv2Reader`` decodes through
    cv2's FFmpeg backend, whose pixels differ from ``cv2.imdecode``'s)."""

    def __init__(self, file):
        file = str(file)
        if file.endswith(".avi"):
            meta = avi_meta(file)
            self.width, self.height, self.fps = meta["width"], meta["height"], meta["fps"]
            self._chunks = iter_video_chunks(file)
            return
        video = jmp4.read_mp4(file).video()
        self.width, self.height = int(video.width), int(video.height)
        self.fps = video.timescale / video.samples[0].duration

        def samples():
            with open(file, "rb") as f:
                for s in video.samples:
                    f.seek(s.offset)
                    yield f.read(s.size)

        self._chunks = samples()

    def read_batch(self, n):
        out = []
        for chunk in self._chunks:
            out.append(cv2.imdecode(np.frombuffer(chunk, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
            if len(out) == n:
                break
        return np.stack(out) if out else None

    def close(self):
        self._chunks.close()


@pytest.fixture(scope="module", autouse=True)
def port_without_ffmpeg():
    """The port's no-ffmpeg route, whatever the host has on PATH, for the
    module's fixtures too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tffmpeg, "have_ffmpeg", lambda: False)
        yield


@pytest.fixture(autouse=True)
def jax_without_ffmpeg(monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")
    for mod in (jffmpeg, jsegmenter, jleak, jhls):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: False)
    monkeypatch.setattr(jreaders, "Cv2Reader", ImdecodeReader)


@pytest.fixture(scope="module")
def frames():
    return blurred_frames(np.random.RandomState(5), N, H, W)


@pytest.fixture(scope="module")
def sources(frames, tmp_path_factory):
    """{'mp4': MJPEG video + 3 s of audio, 'y4m': the same frames, no audio}."""
    d = tmp_path_factory.mktemp("media_src")
    with MjpegAviWriter(d / "src.avi", W, H, FPS, 95) as w:
        w.write_batch(frames)
    audio = audio_payloads(N / FPS, seed=11)
    tmp4.write_mp4(d / "src.mp4", [tmp4.track_from_mjpeg_avi(d / "src.avi"),
                                   audio_track(tmp4, audio)])
    with Y4MWriter(d / "src.y4m", W, H, FPS) as w:
        w.write_batch(frames)
    return {"mp4": d / "src.mp4", "y4m": d / "src.y4m", "audio": b"".join(audio)}


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def run_workflow(fp, src, base, copies, pattern, kw):
    segs = fp.segment_video(src, base / "segments", 1.0)
    marked, payloads, manifest = fp.mark_segments(segs, base / "marked_segments", copies=copies,
                                                  batch_size=8, **kw)
    _, _, seg_map, _ = fp.write_hls_playlists(marked, base / "hls", copies=copies,
                                              segment_duration=1.0)
    fp.write_manifests(base, payloads, manifest, seg_map)
    leaked, info = fp.generate_leak(base / "segment_copies.json", pattern=pattern,
                                    segment_duration=1.0)
    result = fp.trace_leak(leaked, base / "det", base / "segment_payloads.json",
                           segment_duration=1.0, max_copies=copies, **kw)
    return leaked, info, result


@pytest.mark.parametrize("kind,copies,pattern", [("mp4", 2, "101"), ("mp4", 3, "210"),
                                                 ("y4m", 3, "021")])
def test_workflow_trees_equal_jax(sources, tmp_path, kind, copies, pattern):
    out = {}
    for name, fp, kw in (("jax", jfp, {}), ("port", tfp, CPU)):
        out[name] = run_workflow(fp, sources[kind], tmp_path / name, copies, pattern, kw)
    (jleaked, jinfo, jres), (leaked, info, res) = out["jax"], out["port"]
    tj, tp = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tp) == sorted(tj)
    assert [k for k in tp if tp[k] != tj[k]] == []
    assert info == jinfo and leaked.name == jleaked.name
    assert res.to_json() == jres.to_json() and res.fingerprint == jres.fingerprint == pattern
    assert res.success_rate == 1.0
    names = set(tp)
    assert all(f"segments/segment_00{i}.avi" in names for i in range(3))
    assert all(f"marked_segments/marked_seg{i}_copy{c}.avi" in names
               for i in range(3) for c in range(copies))
    if kind == "mp4":
        assert leaked.name == "leaked_video.mp4"
        for i in range(3):
            assert f"segments/segment_00{i}.audio.mp4" in names
            assert f"hls/marked_seg00{i}_copy{copies - 1}.audio.mp4" in names
        m = tmp4.read_mp4(leaked)
        assert m.video().codec_fourcc() == b"jpeg" and len(m.video().samples) == N
        assert sample_bytes(m.audio()) == sources["audio"]
    else:
        assert leaked.name == "leaked_video.avi"
        assert not any(k.endswith(".audio.mp4") for k in names)


def test_rawv_sources_keep_rawv_segments_and_leaks(frames, tmp_path):
    from vfp_tpu_torch.io import RawVideoWriter

    src = tmp_path / "src.rawv"
    with RawVideoWriter(src, W, H, fps=FPS) as w:
        w.write_batch(frames)
    leaked, info, res = run_workflow(tfp, src, tmp_path / "out", 2, "011", CPU)
    assert leaked.name == "leaked_video.rawv" and res.fingerprint == "011"
    names = {p.name for p in (tmp_path / "out").rglob("*")}
    assert "segment_000.rawv" in names and "marked_seg2_copy1.rawv" in names
    assert not any(n.endswith((".avi", ".audio.mp4")) for n in names)


def test_hls_fragments_mp4_variants_with_their_audio(sources, tmp_path):
    """``.mp4`` variants become standalone ``.m4s`` with the sidecar's audio,
    byte-equal to the JAX writer's."""
    segs = tfp.segment_video(sources["mp4"], tmp_path / "segments", 1.0)
    for i, seg in enumerate(segs):  # MJPEG-in-MP4 variants, as a remux would make them
        v = tmp_path / f"v{i}.mp4"
        tmp4.write_mp4(v, [tmp4.track_from_mjpeg_avi(seg)])
        (tmp_path / f"v{i}.audio.mp4").write_bytes(tmp4.audio_sidecar(seg).read_bytes())
    marked = [tfp.MarkedSegment(str(tmp_path / f"v{i}.mp4"), i, 0, [0]) for i in range(3)]
    jmarked = [jfp.MarkedSegment(m.file, m.segment_number, 0, [0]) for m in marked]
    _, _, seg_map, variants = tfp.write_hls_playlists(marked, tmp_path / "port", copies=1)
    _, _, jseg_map, jvariants = jfp.write_hls_playlists(jmarked, tmp_path / "jax", copies=1)
    assert variants == jvariants and seg_map == jseg_map
    assert all(v[0].endswith(".m4s") for v in variants)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    got = b"".join(sample_bytes(tmp4.read_mp4(tmp_path / "port" / v[0]).audio())
                   for v in variants)
    assert got == sources["audio"]
    out = tmp_path / "view.mp4"  # download_view's splice of .m4s variants
    tfp.concatenate_segments([tmp_path / "port" / v[0] for v in variants], out)
    jfp.concatenate_segments([tmp_path / "port" / v[0] for v in variants], tmp_path / "j.mp4")
    assert out.read_bytes() == (tmp_path / "j.mp4").read_bytes()
    assert sample_bytes(tmp4.read_mp4(out).audio()) == sources["audio"]


# -- the service ------------------------------------------------------------------------


def test_service_on_an_audio_mp4_matches_jax(sources, tmp_path):
    kw = {"num_copies": 2, "segment_duration": 1.0}
    svcs = {"jax": jservice.VfpService(tmp_path / "jax", **kw),
            "port": VfpService(tmp_path / "port", device="cpu", **kw)}
    got = {}
    for name, svc in svcs.items():
        summary = svc.process_upload(sources["mp4"])
        views = [svc.start_view(u)["view_number"] for u in ("alice", "bob", "carol")]
        ids = {v["view_number"]: k for k, v in svc.view_history().items()}
        downloads = [svc.download_view(ids[v]) for v in views]
        got[name] = (summary, views, [d.suffix for d in downloads],
                     [d.read_bytes() for d in downloads])
    assert got["port"] == got["jax"]
    assert got["port"][2] == [".mp4"] * 3
    for name in ("segments", "marked_segments", "hls"):
        assert _tree(tmp_path / "port" / name) == _tree(tmp_path / "jax" / name)
    for view in (tmp_path / "port").glob("view_*.mp4"):
        assert sample_bytes(tmp4.read_mp4(view).audio()) == sources["audio"]


@pytest.fixture(scope="module")
def server(sources, tmp_path_factory):
    import threading

    data_dir = tmp_path_factory.mktemp("media_serve")
    srv = tapp.make_server("127.0.0.1", 0, data_dir, device="cpu", num_copies=2,
                           segment_duration=1.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    body, headers = _multipart("file", "title.mp4", sources["mp4"].read_bytes())
    status, resp, _ = _req(base, "/upload", body, headers, "POST")
    assert status == 200 and json.loads(resp)["num_segments"] == 3
    views = {}
    for user in ("alice", "bob", "carol"):
        _, resp, _ = _req(base, "/start-view", json.dumps({"username": user}).encode(),
                          {"Content-Type": "application/json"}, "POST")
        views[user] = json.loads(resp)["view_id"]
    yield base, data_dir, views
    srv.shutdown()
    srv.server_close()


def test_http_download_view_carries_the_audio_and_detect_names_the_viewer(server, sources,
                                                                           tmp_path):
    base, _, views = server
    status, body, headers = _req(base, f"/download-view/{views['bob']}")
    assert status == 200 and headers["Content-Type"] == "video/mp4"
    assert headers["Content-Disposition"].endswith('.mp4"')
    view = tmp_path / "bob.mp4"
    view.write_bytes(body)
    m = tmp4.read_mp4(view)
    assert sample_bytes(m.audio()) == sources["audio"]
    # bob is view 1: copies 0, 0, 1 (base 2); segment 2, copy 1 is his alone
    leak = tmp_path / "leak.mp4"
    video = m.video()
    video.samples = video.samples[12:]
    tmp4.write_mp4(leak, [video])
    body, headers = _multipart("file", "leak.mp4", leak.read_bytes())
    _, resp, _ = _req(base, "/detect", body, headers, "POST")
    data = json.loads(resp)
    assert (data["segment_number"], data["copy_index"]) == (2, 1)
    assert [x["username"] for x in data["matches"]] == ["bob"]
    status, playlist, headers = _req(base, "/hls/marked_seg002_copy1.avi")
    assert status == 200


@pytest.mark.parametrize("name", ["mp4v", "garbage.mp4", "garbage.y4m", "clip.mkv",
                                  "cut.avi"])
def test_http_unreadable_uploads_are_400_and_the_service_keeps_serving(server, tmp_path,
                                                                        name):
    base, data_dir, views = server
    segments_before = sorted(p.name for p in (data_dir / "segments").iterdir())
    if name == "cut.avi":
        # its header and first frames read, so only segmentation finds the cut
        p = tmp_path / "whole.avi"
        with MjpegAviWriter(p, W, H, FPS, 95) as w:
            w.write_batch(blurred_frames(np.random.RandomState(3), 40, H, W))
        whole = p.read_bytes()
        payload, fname = whole[: len(whole) * 7 // 10], name
    elif name == "mp4v":
        p = tmp_path / "v.mp4"
        w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
        for f in blurred_frames(np.random.RandomState(2), 6, H, W):
            w.write(f)
        w.release()
        payload, fname = p.read_bytes(), "v.mp4"
    else:
        payload, fname = b"\x00garbage" * 512, name
    before = (data_dir / "segment_mapping.json").read_bytes()
    for path in ("/upload", "/detect"):
        body, headers = _multipart("file", fname, payload)
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, path, body, headers, "POST")
        assert e.value.code == 400
        detail = json.loads(e.value.read())["detail"]
        if name == "mp4v":
            assert "mp4v" in detail
    assert (data_dir / "segment_mapping.json").read_bytes() == before
    assert sorted(p.name for p in (data_dir / "segments").iterdir()) == segments_before
    assert not (data_dir / "segments.incoming").exists()
    assert _status(base, f"/view/{views['alice']}") == 200
    assert _status(base, "/hls/playlist.m3u8") == 200


# -- the CLI ----------------------------------------------------------------------------


def _run(cli, argv):
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            cli(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def _frames_of(path):
    from vfp_tpu_torch.io import open_reader

    r = open_reader(path)
    try:
        return r.read_batch(10_000)
    finally:
        r.close()


def _majority(text):
    return [line for line in text.splitlines() if line.startswith("majority payload")]


@pytest.mark.parametrize("src_kind,out_name", [("y4m", "out.rawv"), ("y4m", "out.y4m"),
                                               ("mp4", "out.avi")])
def test_cli_mark_and_detect_match_jax(sources, tmp_path, src_kind, out_name):
    outs = {}
    for name, cli, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / f"{name}_{out_name}"
        code, text = _run(cli, ["mark", str(sources[src_kind]), str(out), *extra])
        assert code == 0 and f"marked {N} frames" in text
        code, text = _run(cli, ["detect", str(out), "--payload", PAYLOAD, *extra])
        outs[name] = (code, _majority(text), _frames_of(out))
    (jcode, jmaj, jframes), (code, maj, got) = outs["jax"], outs["port"]
    assert (code, maj) == (jcode, jmaj) == (0, [f"majority payload: {PAYLOAD} (frequency 1.00)"])
    assert got.shape == jframes.shape == (N, H, W, 3)
    assert (got == jframes).mean() >= 0.999


def test_y4m_1080p_expectation_of_the_smoke_holds_in_both_packages(tmp_path):
    """chip_smoke.py's media phase marks its .y4m (``chip_smoke.y4m_frames``,
    16 smooth 1080p frames) into a .y4m and asserts that detect recovers the
    payload; here the JAX CLI and the port both do, on those same frames."""
    src = tmp_path / "in.y4m"
    with Y4MWriter(src, 1920, 1080, 30) as w:
        w.write_batch(chip_smoke.y4m_frames(1080, 1920))
    for name, cli, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / f"{name}.y4m"
        assert _run(cli, ["mark", str(src), str(out), *extra])[0] == 0
        code, text = _run(cli, ["detect", str(out), "--payload", PAYLOAD, *extra])
        assert code == 0, (name, text)
        assert _majority(text) == [f"majority payload: {PAYLOAD} (frequency 1.00)"], name


@pytest.mark.parametrize("kind,verified", [("natural", False), ("smooth", True)])
def test_1080p_content_through_one_q95_generation_in_both_packages(tmp_path, kind, verified):
    """Why chip_smoke.py's media phase codes ``smooth_frames``: at 1080p the
    grainy ``natural_frames`` (the .rawv HLS phase's content, marked there
    with no JPEG between) lose the flagship mark to the q95 JPEG of the
    ``.avi`` variants that ``mark_segments`` writes for an MJPEG source, in
    the JAX package as in the port, while smooth frames keep it.  Both
    packages segment, mark 2 copies and verify; their verdicts are equal."""
    from vfp_tpu.fingerprint import marker as jmarker
    from vfp_tpu_torch.fingerprint import marker as tmarker

    frames = getattr(chip_smoke, f"{kind}_frames")(np.random.RandomState(16), 8, 1080, 1920)
    with MjpegAviWriter(tmp_path / "src.avi", 1920, 1080, 30, 95) as w:
        w.write_batch(frames)
    tmp4.write_mp4(tmp_path / "src.mp4", [tmp4.track_from_mjpeg_avi(tmp_path / "src.avi")])
    verdicts = {}
    for name, fp, marker, kw in (("jax", jfp, jmarker, {}), ("port", tfp, tmarker, CPU)):
        segs = fp.segment_video(tmp_path / "src.mp4", tmp_path / name / "segments", 8 / 30)
        marked, _, _ = fp.mark_segments(segs, tmp_path / name / "marked", copies=2,
                                        batch_size=8, **kw)
        assert [Path(m.file).suffix for m in marked] == [".avi", ".avi"]
        verdicts[name] = [(r[0].tolist(), r[2]) for r in
                          (marker.verify_segment(m.file, m.payload, **kw) for m in marked)]
    assert verdicts["port"] == verdicts["jax"]
    assert [ok for _, ok in verdicts["port"]] == [verified, verified], verdicts


def test_cli_hls_leak_trace_on_an_audio_mp4(sources, tmp_path):
    out = tmp_path / "o"
    cpu = ["--device", "cpu"]
    code, text = _run(port_cli, ["hls-mark", str(sources["mp4"]), str(out), "--copies", "3",
                                 "--segment-duration", "1", *cpu])
    assert code == 0 and "All segments were watermarked successfully!" in text
    code, text = _run(port_cli, ["leak", str(out / "segment_copies.json"), "--pattern", "120",
                                 "--segment-duration", "1", *cpu])
    assert f"leaked video: {out / 'leaked_video.mp4'}" in text
    code, text = _run(port_cli, ["trace", str(out / "leaked_video.mp4"), str(tmp_path / "det"),
                                 "--payload-file", str(out / "segment_payloads.json"),
                                 "--segment-duration", "1", *cpu])
    assert "Copy fingerprint: 120" in text and "Success rate: 100.00%" in text
    audio = tmp4.read_mp4(out / "leaked_video.mp4").audio()
    assert sample_bytes(audio) == sources["audio"]


def test_non_jpeg_mp4_video_raises_naming_the_fourcc(tmp_path):
    p = tmp_path / "v.mp4"
    w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for f in blurred_frames(np.random.RandomState(2), 6, H, W):
        w.write(f)
    w.release()
    cpu = ["--device", "cpu"]
    for argv in (["mark", str(p), str(tmp_path / "o.rawv"), *cpu],
                 ["detect", str(p), *cpu],
                 ["hls-mark", str(p), str(tmp_path / "h"), *cpu],
                 ["trace", str(p), str(tmp_path / "det"), *cpu]):
        with pytest.raises(IOError, match="mp4v"):
            port_cli(argv)
    with pytest.raises(IOError, match="mp4v"):
        VfpService(tmp_path / "svc", device="cpu").process_upload(p)


def test_durability_mp4_container_explains_the_refusal(tmp_path):
    from vfp_tpu_torch.workflows.durability import run_durability

    with pytest.raises(ValueError, match="no mp4v encoder and no mp4v decoder"):
        run_durability(tmp_path / "x.rawv", tmp_path / "d", container="mp4", device="cpu")


# -- --wm-image as cv2.imread(..., IMREAD_GRAYSCALE) --------------------------------------


def _png_gray_alpha(path, ga):
    """A gray + alpha PNG (colour type 4), which cv2 does not write."""
    import struct
    import zlib

    from vfp_tpu_torch.io.images import PNG_SIGNATURE, _chunk

    h, w = ga.shape[:2]
    raw = np.zeros((h, 2 * w + 1), np.uint8)
    raw[:, 1:] = ga.reshape(h, -1)
    hdr = struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0)
    path.write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", hdr)
                     + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba", "rgb_port_writer",
                                  "jpeg", "jpeg_odd"])
def test_read_image_gray_is_cv2_imread_grayscale(tmp_path, kind):
    rng = np.random.RandomState(sorted(["gray", "gray_alpha", "rgb", "rgba", "rgb_port_writer",
                                        "jpeg", "jpeg_odd"]).index(kind))
    h, w = (37, 53) if kind != "jpeg_odd" else (61, 45)
    img = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    img[: h // 2, : w // 2, 1:3] = img[: h // 2, : w // 2, :1]  # some gray pixels (r = g = b)
    p = tmp_path / ("img.jpg" if kind.startswith("jpeg") else "img.png")
    if kind == "gray":
        cv2.imwrite(str(p), img[..., 0])
    elif kind == "gray_alpha":
        _png_gray_alpha(p, img[..., :2])
    elif kind == "rgb":
        cv2.imwrite(str(p), img[..., :3])
    elif kind == "rgba":
        cv2.imwrite(str(p), img)
    elif kind == "rgb_port_writer":
        write_png(p, img[..., :3])
    else:
        p.write_bytes(encode_jpeg(img[..., :3], 90))
    got = read_image_gray(p)
    want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)


def test_read_image_gray_refuses_what_it_cannot_match(tmp_path):
    from vfp_tpu_torch.native.jpeg import encode_jpeg_gray

    cases = {"x.bmp": b"BM" + bytes(60), "x.jpg": encode_jpeg_gray(np.zeros((8, 8), np.uint8))}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(IOError):
            read_image_gray(tmp_path / name)
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), np.zeros((4, 4), np.uint16))
    with pytest.raises(IOError, match="bit depth 16"):
        read_image_gray(deep)


def test_cli_mark_with_a_colour_wm_image_matches_jax(frames, tmp_path):
    from vfp_tpu_torch.io import RawVideoWriter

    src = tmp_path / "src.rawv"
    with RawVideoWriter(src, W, H, fps=FPS) as w:
        w.write_batch(frames[:4])
    logo = tmp_path / "logo.png"
    cv2.imwrite(str(logo), np.random.RandomState(3).randint(0, 256, (4, 4, 3)).astype(np.uint8))
    got = {}
    for name, cli, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / f"{name}.rawv"
        code, _ = _run(cli, ["mark", str(src), str(out), "--generator", "grayscale",
                             "--wm-image", str(logo), *extra])
        assert code == 0
        r = RawVideoReader(out)
        got[name] = r.read_batch(100)
        r.close()
    assert (got["port"] == got["jax"]).mean() >= 0.999


# -- the farm on .avi segments with sidecars ---------------------------------------------


@pytest.fixture(scope="module")
def avi_segments(sources, tmp_path_factory):
    d = tmp_path_factory.mktemp("farm_media")
    segs = [str(s) for s in tfp.segment_video(sources["mp4"], d / "segs", 1.0)]
    serial = tfp.mark_segments(segs, d / "serial", copies=2, batch_size=8, **CPU)
    return segs, serial


def _same_outputs(serial, other_dir, marked, payloads, copies):
    s_marked, s_payloads, s_copies = serial
    assert payloads == s_payloads and copies == s_copies
    assert [Path(m.file).name for m in marked] == [Path(m.file).name for m in s_marked]
    serial_dir = Path(s_marked[0].file).parent
    want = {p.name: p.read_bytes() for p in serial_dir.iterdir()}
    got = {p.name: p.read_bytes() for p in Path(other_dir).iterdir()
           if not p.name.startswith("manifest_rank")}
    assert got == want
    assert sum(n.endswith(".audio.mp4") for n in got) == 6


def test_farm_on_avi_segments_with_sidecars_matches_serial(avi_segments, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    segs, serial = avi_segments
    m, p, c = mark_segments_parallel(segs, tmp_path / "farm", copies=2, workers=2, batch_size=8,
                                     worker_device="cpu")
    _same_outputs(serial, tmp_path / "farm", m, p, c)
    m, p, c = mark_segments_distributed(segs, tmp_path / "dist", copies=2, batch_size=8, **CPU)
    _same_outputs(serial, tmp_path / "dist", m, p, c)
    job = {"name": "farm", "kind": "farm", "segments": segs, "marked_dir": str(tmp_path / "two"),
           "copies": 2, "world": 2, "coordinator": f"127.0.0.1:{free_port()}"}
    merged = run_ranks(2, [job], tmp_path / "ranks")[0]["farm"]
    marked = [tfp.MarkedSegment(*x) for x in merged["marked"]]
    _same_outputs(serial, tmp_path / "two", marked, merged["payloads"], merged["copies"])


def test_farm_workers_go_to_their_own_cards(tmp_path, monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = [tfarm.worker_placement("cuda", r) for r in range(6)]
    assert got == [torch.device("cuda", r % 4) for r in range(6)]
    assert tfarm.worker_placement("cuda:2", 3) == torch.device("cuda", 2)
    assert tfarm.worker_placement("cpu", 3) == torch.device("cpu")
    seen = []

    class Pool:  # the spawned pool, recording each worker's task instead
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, tasks):
            seen.extend(t[-1] for t in tasks)
            return []

    monkeypatch.setattr(tfarm, "ProcessPoolExecutor", Pool)
    monkeypatch.setattr("vfp_tpu_torch.kernels._build.library", lambda: None)
    mark_segments_parallel([f"s{i}.rawv" for i in range(6)], tmp_path / "m", workers=3,
                           worker_device=torch.device("cuda"))
    assert seen == ["cuda:0", "cuda:1", "cuda:2"]
