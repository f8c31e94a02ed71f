"""vfp_tpu_torch.serve against vfp_tpu.serve, on the CPU, and the port's
HTTP contract.

The JAX tests' size: 12 frames of 96x64 at 6 fps, 1 s segments (two of 6
frames), 2 copies.  The JAX service runs on the port's ``.rawv`` segments
(its ``segment_video`` replaced by the port's, which the fingerprint tests
hold frame-exact against the source) and marks them with
``out_ext=".rawv"``, on the full-frame path (VFP_LOWLINK=0); nothing in
``vfp_tpu`` changes.  Stated tolerance: variant files identical on >= 99.9%
of pixels each (the ±1 class of ``test_torch_fingerprint.py``); pages,
parsed multipart bodies, manifests, playlists, view sequences and detect
responses exactly equal (absolute paths relative to each data dir, view
ids mapped by view number, timestamps compared by presence).
"""

import concurrent.futures
import functools
import json
import random
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from vfp_tpu.fingerprint import marker as jmarker
from vfp_tpu.serve import app as japp, service as jservice, templates as jtemplates
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.fingerprint import segment_video as port_segment_video
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter
from vfp_tpu_torch.serve import VfpService
from vfp_tpu_torch.serve import app as tapp, templates as ttemplates

from torch_parity import natural_frames

torch.set_num_threads(1)
H, W, FPS, N = 64, 96, 6, 12
KW = {"num_copies": 2, "segment_duration": 1.0}
USERS = ("alice", "bob", "carol")


@pytest.fixture(autouse=True)
def full_frame_jax_path(monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")


@pytest.fixture(scope="module")
def jax_on_rawv():
    """The JAX service's segmenter and marker, on .rawv files."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VFP_LOWLINK", "0")
        mp.setattr(jservice, "segment_video", port_segment_video)
        mp.setattr(jservice, "mark_segments",
                   functools.partial(jmarker.mark_segments, out_ext=".rawv"))
        yield


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(10_000)
    finally:
        r.close()


def _multipart(field, filename, payload):
    boundary = uuid.uuid4().hex
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; "
        f'name="{field}"; filename="{filename}"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _req(base, path, data=None, headers=None, method=None):
    req = urllib.request.Request(base + path, data=data, headers=headers or {}, method=method)
    with urllib.request.urlopen(req) as r:
        return r.status, r.read(), dict(r.headers)


def _status(base, path, data=None, headers=None, method=None):
    try:
        return _req(base, path, data, headers, method)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    p = tmp_path_factory.mktemp("servesrc") / "src.rawv"
    with RawVideoWriter(p, W, H, fps=FPS) as w:
        w.write_batch(natural_frames(np.random.RandomState(21), N, H, W))
    return p


@pytest.fixture(scope="module")
def services(source, jax_on_rawv, tmp_path_factory):
    """The same upload and the same three views on both services."""
    base = tmp_path_factory.mktemp("services")
    out = {}
    for name, svc in (("jax", jservice.VfpService(base / "jax", **KW)),
                      ("port", VfpService(base / "port", device="cpu", **KW))):
        summary = svc.process_upload(source)
        views = [svc.start_view(u) for u in USERS]
        out[name] = (svc, summary, views)
    return out


def _relative(obj, root):
    """``obj`` with every absolute path under ``root`` made relative to it."""
    text = json.dumps(obj).replace(str(root) + "/", "")
    return json.loads(text)


# -- pages and the multipart parser ---------------------------------------------------

@pytest.mark.parametrize("page", ["upload", "view", "detect"])
def test_render_page_is_byte_equal_to_jax(page):
    assert ttemplates.render_page(page).encode() == jtemplates.render_page(page).encode()


def _random_body(rng: random.Random, boundary: str) -> bytes:
    body = rng.choice([b"", b"preamble\r\n", b"\r\n"])
    for _ in range(rng.randint(0, 3)):
        fn = rng.choice(["", '; filename="a.rawv"', '; filename=""'])
        data = bytes(rng.choice(b"\r\n-ab\x00") for _ in range(rng.randint(0, 40)))
        body += (f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="{rng.choice(["file", "copies"])}"{fn}\r\n\r\n').encode() + data + b"\r\n"
    return body + f"--{boundary}--\r\n".encode() + rng.choice([b"", b"\r\n", b"x\r\n\r\ny"])


@pytest.mark.parametrize("seed", range(4))
def test_parse_multipart_matches_jax(seed):
    """Random bodies whose data ends in CR, LF and dashes (which both
    parsers strip), repeated and missing fields, quoted boundaries."""
    rng = random.Random(seed)
    for _ in range(100):
        boundary = uuid.uuid4().hex
        body = _random_body(rng, boundary)
        for ct in (f"multipart/form-data; boundary={boundary}",
                   f'multipart/form-data; boundary="{boundary}"; charset=x'):
            assert tapp.parse_multipart(body, ct) == japp.parse_multipart(body, ct)
    for body in (b"", b"--x", b"--x--", b"--x\r\nname=\"a\"\r\n\r\n--x"):
        ct = "multipart/form-data; boundary=x"
        assert tapp.parse_multipart(body, ct) == japp.parse_multipart(body, ct)


@pytest.mark.parametrize("ct", ["multipart/form-data", "", "text/plain"])
def test_parse_multipart_without_boundary_raises_as_jax(ct):
    for parse in (tapp.parse_multipart, japp.parse_multipart):
        with pytest.raises(ValueError, match="no multipart boundary"):
            parse(b"abc", ct)


# -- the service against vfp_tpu.serve -------------------------------------------------

def test_upload_matches_jax(services):
    (jsvc, jsum, _), (tsvc, tsum, _) = services["jax"], services["port"]
    assert tsum == jsum
    assert tsum["num_segments"] == 2 and tsum["total_variants"] == 4 and not tsum["failed_segments"]
    for name in ("segment_payloads.json", "segment_copies.json"):
        assert (tsvc.data_dir / name).read_text() == (jsvc.data_dir / name).read_text()
    assert (_relative(json.loads(tsvc.mapping_file.read_text()), tsvc.data_dir)
            == _relative(json.loads(jsvc.mapping_file.read_text()), jsvc.data_dir))
    names = sorted(p.name for p in tsvc.hls_dir.iterdir())
    assert names == sorted(p.name for p in jsvc.hls_dir.iterdir())
    for name in names:
        if name.endswith(".m3u8"):
            assert (tsvc.hls_dir / name).read_text() == (jsvc.hls_dir / name).read_text()
        else:
            a, b = _read(tsvc.hls_dir / name), _read(jsvc.hls_dir / name)
            assert a.shape == b.shape == (N // 2, H, W, 3)
            assert (a == b).mean() >= 0.999, (name, (a == b).mean())


def test_start_view_sequence_and_playlists_match_jax(services):
    (jsvc, _, jviews), (tsvc, _, tviews) = services["jax"], services["port"]
    assert [v["view_number"] for v in tviews] == [0, 1, 2]
    for jv, tv in zip(jviews, tviews):
        assert (_relative(tv, tsvc.data_dir) | {"view_id": None}
                == _relative(jv, jsvc.data_dir) | {"view_id": None})
        assert tsvc.view_playlist(tv["view_id"]) == jsvc.view_playlist(jv["view_id"])
    playlists = [tsvc.view_playlist(v["view_id"]) for v in tviews]
    assert len(set(playlists)) == 3
    assert "marked_seg000_copy0" in playlists[1] and "marked_seg001_copy1" in playlists[1]
    # view_history.json holds the same views (ids and timestamps aside)
    def views(svc):
        return sorted((_relative({k: v for k, v in view.items() if k != "timestamp"}, svc.data_dir)
                       for view in svc.view_history().values()), key=lambda v: v["view_number"])
    assert views(tsvc) == views(jsvc)


@pytest.mark.parametrize("seg,copy", [(1, 1), (0, 1), (1, 0)])
def test_detect_matches_jax(services, seg, copy):
    (jsvc, _, jviews), (tsvc, _, tviews) = services["jax"], services["port"]
    leak = f"marked_seg{seg:03d}_copy{copy}.rawv"
    got, want = tsvc.detect(tsvc.hls_dir / leak), jsvc.detect(jsvc.hls_dir / leak)
    ids = {jv["view_id"]: tv["view_id"] for jv, tv in zip(jviews, tviews)}
    for m in want["matches"]:
        m["view_id"] = ids[m["view_id"]]
    for resp in (got, want):
        for m in resp["matches"]:
            assert m.pop("timestamp")
    assert got == want
    assert got["status"] == "success" and (got["segment_number"], got["copy_index"]) == (seg, copy)
    assert got["frequency"] == 1.0
    # views 0, 1, 2 play copies [0, 0], [0, 1], [1, 0]
    users = {m["username"] for m in got["matches"]}
    assert users == {u for u, pat in zip(USERS, ([0, 0], [0, 1], [1, 0])) if pat[seg] == copy}


def test_the_port_serves_a_data_dir_the_jax_service_wrote(source, jax_on_rawv, tmp_path):
    """Carrying state across: views started by the JAX service play and are
    detected by the port's service as by the JAX one; new views number on."""
    jsvc = jservice.VfpService(tmp_path, **KW)
    jsvc.process_upload(source)
    jviews = [jsvc.start_view(u) for u in USERS[:2]]
    tsvc = VfpService(tmp_path, device="cpu", **KW)
    for v in jviews:
        assert tsvc.view_playlist(v["view_id"]) == jsvc.view_playlist(v["view_id"])
    leak = tsvc.hls_dir / "marked_seg001_copy1.rawv"
    got, want = tsvc.detect(leak), jsvc.detect(leak)
    assert got == want and [m["username"] for m in got["matches"]] == ["bob"]
    assert tsvc.start_view("carol")["view_number"] == 2
    assert len(jsvc.view_history()) == 3


# -- the port's HTTP contract on the CPU ------------------------------------------------

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("portserve")
    srv = tapp.make_server("127.0.0.1", 0, data_dir, device="cpu", **KW)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", data_dir
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


@pytest.fixture(scope="module")
def uploaded(server, source):
    base, _ = server
    body, headers = _multipart("file", "src.rawv", source.read_bytes())
    status, resp, _ = _req(base, "/upload", body, headers, "POST")
    assert status == 200
    return json.loads(resp)


def test_http_pages_and_upload(server, uploaded):
    base, _ = server
    for path in ("/", "/upload", "/view", "/detect"):
        status, body, headers = _req(base, path)
        assert status == 200 and b"<html>" in body
        assert headers["Content-Type"] == "text/html; charset=utf-8"
        assert headers["Access-Control-Allow-Origin"] == "*"
    assert uploaded["status"] == "success" and uploaded["total_variants"] == 4


@pytest.mark.parametrize("path", ["/view/nonexistent", "/hls/missing.rawv",
                                  "/download-view/nonexistent", "/nope"])
def test_http_unknown_things_are_404(server, uploaded, path):
    assert _status(server[0], path) == 404


def test_http_unknown_post_is_404(server):
    assert _status(server[0], "/nope", b"{}", {"Content-Type": "application/json"}, "POST") == 404


def test_http_views_playlists_hls_and_download(server, uploaded):
    base, data_dir = server
    status, resp, _ = _req(base, "/start-view", json.dumps({"username": "dave"}).encode(),
                           {"Content-Type": "application/json"}, "POST")
    view = json.loads(resp)
    status, m3u8, headers = _req(base, f"/view/{view['view_id']}")
    assert status == 200 and m3u8.startswith(b"#EXTM3U")
    assert headers["Content-Type"] == "application/vnd.apple.mpegurl"
    assert headers["Cache-Control"] == "no-cache"
    status, _, headers = _req(base, "/hls/playlist.m3u8")
    assert headers["Content-Type"] == "application/vnd.apple.mpegurl"
    names = [line.rsplit("/", 1)[1] for line in m3u8.decode().splitlines()
             if line.startswith("/hls/")]
    status, seg, headers = _req(base, f"/hls/{names[0]}")
    assert headers["Content-Type"] == "application/octet-stream"
    assert seg == (data_dir / "hls" / names[0]).read_bytes()
    status, data, headers = _req(base, f"/download-view/{view['view_id']}")
    assert status == 200 and headers["Content-Type"] == "video/mp4"
    assert headers["Content-Disposition"] == f'attachment; filename="view_{view["view_id"]}.rawv"'
    spliced = data_dir / "spliced.rawv"
    spliced.write_bytes(data)
    np.testing.assert_array_equal(
        _read(spliced), np.concatenate([_read(data_dir / "hls" / n) for n in names]))
    assert _status(base, "/start-view", b"{}", {"Content-Type": "application/json"},
                   "POST") == 400  # no username


def test_http_detect_identifies_the_viewer(server, uploaded):
    base, data_dir = server
    for name in ("erin", "frank"):  # view numbers after the earlier tests' views
        _req(base, "/start-view", json.dumps({"username": name}).encode(),
             {"Content-Type": "application/json"}, "POST")
    leaked = data_dir / "hls" / "marked_seg001_copy1.rawv"
    body, headers = _multipart("file", leaked.name, leaked.read_bytes())
    status, resp, headers = _req(base, "/detect", body, headers, "POST")
    data = json.loads(resp)
    assert status == 200 and headers["Content-Type"] == "application/json"
    assert data["status"] == "success" and (data["segment_number"], data["copy_index"]) == (1, 1)
    history = json.loads(_req(base, "/view-history")[1])
    odd = {v["username"] for v in history.values() if v["view_number"] % 2 == 1}
    assert {m["username"] for m in data["matches"]} == odd
    for m in data["matches"]:
        assert isinstance(m["timestamp"], str) and m["timestamp"]
        assert m["payload"] == data["pattern"] and m["frequency"] == 1.0


@pytest.mark.parametrize("name,payload", [("evil.mp4", b"\x00garbage" * 512),
                                          ("evil.rawv", b"\x00garbage" * 512),
                                          ("short.rawv", b"VFPRAWV1" + b"\x01" * 40)])
def test_http_bad_uploads_are_400_and_keep_the_state(server, uploaded, name, payload):
    base, data_dir = server
    before = {p: (data_dir / p).read_bytes() for p in ("segment_mapping.json",
                                                       "segment_copies.json")}
    hls_before = sorted(p.name for p in (data_dir / "hls").iterdir())
    body, headers = _multipart("file", name, payload)
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, "/upload", body, headers, "POST")
    assert e.value.code == 400 and json.loads(e.value.read())["detail"]
    assert {p: (data_dir / p).read_bytes() for p in before} == before
    assert sorted(p.name for p in (data_dir / "hls").iterdir()) == hls_before
    assert (data_dir / "segments").is_dir() and (data_dir / "marked_segments").is_dir()
    assert _status(base, "/hls/playlist.m3u8") == 200


@pytest.mark.parametrize("name", ["leak.mp4", "leak.rawv"])
def test_http_garbage_detect_is_400(server, uploaded, name):
    body, headers = _multipart("file", name, b"not video" * 99)
    assert _status(server[0], "/detect", body, headers, "POST") == 400


@pytest.mark.parametrize("path", ["/upload", "/detect"])
def test_http_missing_boundary_or_file_is_400(server, path):
    base, _ = server
    assert _status(base, path, b"no boundary here", {"Content-Type": "multipart/form-data"},
                   "POST") == 400
    body, headers = _multipart("other", "x.rawv", b"abc")
    assert _status(base, path, body, headers, "POST") == 400


def test_http_parallel_start_views_get_unique_numbers(server, uploaded):
    base, _ = server

    def start(i):
        _, resp, _ = _req(base, "/start-view", json.dumps({"username": f"user{i}"}).encode(),
                          {"Content-Type": "application/json"}, "POST")
        return json.loads(resp)["view_number"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        numbers = list(pool.map(start, range(16)))
    assert len(set(numbers)) == 16, numbers


def test_bad_segment_falls_back_to_unmarked(source, tmp_path):
    svc = VfpService(tmp_path / "data", device="cpu", **KW)
    svc.process_upload(source)
    segs = sorted((tmp_path / "data" / "segments").iterdir())
    segs[1].write_bytes(b"garbage not a video")
    marked, payloads, copies, failed = svc._mark_with_fallback(segs)
    assert len(failed) == 1 and failed[0]["segment_number"] == 1
    assert copies["total_marked_segments"] == 4 and len(payloads) == 4
    fallback = [m for m in marked if m.segment_number == 1]
    assert [m.copy_index for m in fallback] == [0, 1]
    for m in fallback:
        assert (tmp_path / "data" / "marked_segments" / m.file.split("/")[-1]).read_bytes() \
            == b"garbage not a video"


def test_serve_defaults_to_cuda_and_never_drops_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(["serve", "--port", "0", "--data-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tapp.make_server("127.0.0.1", 0, tmp_path)
