"""vfp_tpu_torch.io.mp4 and the MJPEG-in-MP4 reader against vfp_tpu.io.mp4,
on the CPU.

Every public function of the box library runs on the same inputs in both
packages and must write the same bytes (``read_bytes()`` equal) and parse to
the same tracks and samples.  Inputs: MJPEG ``.avi`` files written by the
port's ``MjpegAviWriter`` (64x48, 6 fps, seeded numpy frames), a synthetic
``soun`` track (a hand-written ``mp4a`` sample entry with an ``esds`` box
and seeded random sample bytes: the library never decodes audio, so box
arithmetic is all that is exercised), and cv2's ``mp4v`` writer for a
foreign progressive file (only here, in the test).  The audio helpers are
``chip_smoke.py``'s, which makes the media path's track the same way.  The fuzz cases are the
JAX tests' (truncations, byte flips, garbage, hostile counts): both packages
must give the same outcome, a parse with equal tracks or an IOError.
No tolerance: every comparison is exact.
"""

import struct
import time

import cv2
import numpy as np
import pytest

import vfp_tpu.io.mp4 as jmp4
import vfp_tpu_torch.io.mp4 as tmp4
from vfp_tpu_torch.io import MjpegAviWriter, Mp4MjpegReader, open_reader, open_writer

from chip_smoke import audio_payloads, audio_track, sample_bytes

H, W, FPS = 48, 64, 6


def track_key(tr):
    """Every field of a track and its samples, package-neutral."""
    return (tr.handler, tr.timescale, bytes(tr.stsd), tr.width, tr.height, tr.volume,
            tr.language, tr.track_id,
            [(s.src, s.offset, s.size, s.duration, s.sync, s.cts, s.data) for s in tr.samples])


def file_key(m):
    return m.timescale, [track_key(t) for t in m.tracks]


def frames_of(seed, n=6, h=H, w=W):
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 255, (n, h // 8, w // 8, 3)).astype(np.uint8)
    return np.repeat(np.repeat(small, 8, 1), 8, 2)


@pytest.fixture(scope="module")
def avis(tmp_path_factory):
    """Three MJPEG AVIs of 6 frames, written by the port."""
    d = tmp_path_factory.mktemp("mp4avis")
    out = []
    for i in range(3):
        p = d / f"s{i}.avi"
        with MjpegAviWriter(p, W, H, FPS, 90) as w:
            w.write_batch(frames_of(i))
        out.append(p)
    return out


@pytest.fixture(scope="module")
def mp4v(tmp_path_factory):
    """A cv2-written mp4v file (a foreign progressive layout)."""
    p = tmp_path_factory.mktemp("mp4v") / "v.mp4"
    w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for f in frames_of(7, 8):
        w.write(f)
    w.release()
    return p


def both(fn_name, *args, **kw):
    return getattr(jmp4, fn_name)(*args, **kw), getattr(tmp4, fn_name)(*args, **kw)


def write_both(tmp_path, name, build):
    """``build(mod, path)`` through each package; returns the two paths, bytes equal."""
    pj, pt = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    build(jmp4, pj)
    build(tmp4, pt)
    assert pt.read_bytes() == pj.read_bytes()
    return pj, pt


def av_mp4(mod, path, avi, seconds=1.0, seed=0):
    """MJPEG video of ``avi`` plus ``seconds`` of synthetic audio."""
    mod.write_mp4(path, [mod.track_from_mjpeg_avi(avi),
                         audio_track(mod, audio_payloads(seconds, seed))])


# -- parse and write --------------------------------------------------------------------


def test_track_from_mjpeg_avi_matches_jax(avis):
    j, t = both("track_from_mjpeg_avi", avis[0])
    assert track_key(t) == track_key(j)
    assert t.codec_fourcc() == b"jpeg" and len(t.samples) == 6
    j, t = both("track_from_mjpeg_avi", avis[1], timescale=90000)
    assert track_key(t) == track_key(j)


def test_progressive_with_audio_is_byte_equal(avis, tmp_path):
    pj, pt = write_both(tmp_path, "av.mp4", lambda m, p: av_mp4(m, p, avis[0], 1.0))
    assert file_key(tmp4.read_mp4(pt)) == file_key(jmp4.read_mp4(pt))
    m = tmp4.read_mp4(pt)
    assert m.video().codec_fourcc() == b"jpeg" and m.audio().codec_fourcc() == b"mp4a"
    assert sample_bytes(m.audio()) == b"".join(audio_payloads(1.0))
    assert sample_bytes(m.video()) == sample_bytes(tmp4.track_from_mjpeg_avi(avis[0]))


def test_read_mp4_parses_as_jax(avis, mp4v, tmp_path):
    pj, pt = write_both(tmp_path, "av.mp4", lambda m, p: av_mp4(m, p, avis[1], 1.0, seed=3))
    for path in (pt, mp4v):
        assert file_key(tmp4.read_mp4(path)) == file_key(jmp4.read_mp4(path))
    assert tmp4.read_mp4(mp4v).video().codec_fourcc() == b"mp4v"
    # a rewrite of the foreign file: its sample tables rebuilt, its bytes copied
    write_both(tmp_path, "rw.mp4", lambda m, p: m.write_mp4(p, m.read_mp4(mp4v).tracks))


def test_iter_boxes_and_missing_moov_match_jax(tmp_path):
    data = jmp4._box(b"ftyp", b"isom" + bytes(8)) + jmp4._box(b"free", bytes(5))
    assert list(tmp4.iter_boxes(data, 0, len(data))) == list(jmp4.iter_boxes(data, 0, len(data)))
    p = tmp_path / "x.mp4"
    p.write_bytes(b"\x00\x00\x00\x08free")
    for mod in (jmp4, tmp4):
        with pytest.raises(IOError, match="no moov"):
            mod.read_mp4(p)


def test_fragment_is_byte_equal_and_parses(avis, tmp_path):
    src = tmp_path / "av.mp4"
    av_mp4(tmp4, src, avis[0], 1.0)
    extra = audio_payloads(0.5, seed=9)

    def frag(mod, p):
        mod.fragment_mp4(src, p, extra_tracks=[audio_track(mod, extra)])

    pj, pt = write_both(tmp_path, "f.m4s", frag)
    write_both(tmp_path, "plain.m4s", lambda m, p: m.fragment_mp4(src, p))
    assert file_key(tmp4.read_mp4(pt)) == file_key(jmp4.read_mp4(pt))
    got = tmp4.read_mp4(pt)
    assert [len(t.samples) for t in got.tracks] == [6, len(audio_payloads(1.0)), len(extra)]
    assert sample_bytes(got.video()) == sample_bytes(tmp4.read_mp4(src).video())


def test_concat_of_mp4_and_m4s_is_byte_equal(avis, tmp_path):
    parts = []
    for i, avi in enumerate(avis):
        p = tmp_path / f"p{i}.mp4"
        av_mp4(tmp4, p, avi, 1.0, seed=i)
        if i == 1:
            q = tmp_path / "p1.m4s"
            tmp4.fragment_mp4(p, q)
            p = q
        parts.append(p)
    pj, pt = write_both(tmp_path, "cat.mp4", lambda m, p: m.concat_mp4(parts, p))
    m = tmp4.read_mp4(pt)
    assert len(m.video().samples) == 18
    assert sample_bytes(m.audio()) == b"".join(
        b"".join(audio_payloads(1.0, seed=i)) for i in range(3))


def test_concat_codec_mismatch_raises_in_both(avis, mp4v, tmp_path):
    p = tmp_path / "mj.mp4"
    tmp4.write_mp4(p, [tmp4.track_from_mjpeg_avi(avis[0])])
    for mod in (jmp4, tmp4):
        with pytest.raises(IOError, match="codec mismatch"):
            mod.concat_mp4([p, mp4v], tmp_path / "bad.mp4")


def test_largesize_mdat_and_co64_are_byte_equal(avis, tmp_path, monkeypatch):
    """The 64-bit mdat header and co64 offsets, with the u32 limit shrunk in
    both packages so that a small file takes the path."""
    monkeypatch.setattr(jmp4, "_MDAT_U32_MAX", 64)
    monkeypatch.setattr(tmp4, "_MDAT_U32_MAX", 64)
    parts = []
    for i, avi in enumerate(avis):
        p = tmp_path / f"q{i}.mp4"
        av_mp4(jmp4, p, avi, 1.0, seed=i)
        parts.append(p)
    pj, pt = write_both(tmp_path, "big.mp4", lambda m, p: m.concat_mp4(parts, p))
    raw = pt.read_bytes()
    pos = raw.find(b"mdat") - 4
    assert raw[pos: pos + 4] == b"\x00\x00\x00\x01" and b"co64" in raw
    assert file_key(tmp4.read_mp4(pt)) == file_key(jmp4.read_mp4(pt))
    assert sample_bytes(tmp4.read_mp4(pt).video()) == b"".join(
        sample_bytes(tmp4.read_mp4(p).video()) for p in parts)


def test_multi_trun_offset_carry_matches_jax():
    """Several truns in one traf, the later ones without a data offset:
    each continues after the previous run's bytes (ISO 14496-12 8.8.8)."""
    sizes1, sizes2 = [5, 7], [11, 3]

    def build(mod, moof_len):
        tfhd = mod._full(b"tfhd", 0, 0x020000, struct.pack(">I", 1))
        trun1 = mod._full(b"trun", 1, 0x000001 | 0x000200,
                          struct.pack(">Ii", len(sizes1), moof_len + 8)
                          + b"".join(struct.pack(">I", s) for s in sizes1))
        trun2 = mod._full(b"trun", 1, 0x000200, struct.pack(">I", len(sizes2))
                          + b"".join(struct.pack(">I", s) for s in sizes2))
        mfhd = mod._full(b"mfhd", 0, 0, struct.pack(">I", 1))
        return mod._box(b"moof", mfhd + mod._box(b"traf", tfhd + trun1 + trun2))

    got = []
    for mod in (jmp4, tmp4):
        moof = build(mod, len(build(mod, 0)))
        buf = moof + mod._box(b"mdat", bytes(range(sum(sizes1) + sum(sizes2))))
        tr = mod.Track(handler=b"vide", timescale=600, stsd=b"", track_id=1)
        mod._parse_fragments(buf, "synthetic", {1: tr})
        got.append((buf, track_key(tr)))
    assert got[0] == got[1]
    base = len(build(tmp4, 0)) + 8
    assert [s[1] for s in got[1][1][8]] == [base, base + 5, base + 12, base + 23]


def test_slice_and_add_audio_are_byte_equal(avis, tmp_path):
    payloads = audio_payloads(3.0, seed=4)
    cuts = [(0.0, 1.0), (1.0, 2.0), (2.0, 9.0)]
    pieces = []
    for t0, t1 in cuts:
        j = jmp4.slice_track_by_time(audio_track(jmp4, payloads), t0, t1)
        t = tmp4.slice_track_by_time(audio_track(tmp4, payloads), t0, t1)
        assert track_key(t) == track_key(j)
        pieces.append(sample_bytes(t))
    assert b"".join(pieces) == b"".join(payloads)

    def add(mod, p, out=None):
        mod.write_mp4(p, [mod.track_from_mjpeg_avi(avis[2])])
        mod.add_audio_track(p, mod.slice_track_by_time(audio_track(mod, payloads), 0.0, 1.0),
                            output=out)

    write_both(tmp_path, "inplace.mp4", add)
    write_both(tmp_path, "out.mp4", lambda m, p: add(m, p.with_suffix(".v.mp4"), p))
    m = tmp4.read_mp4(tmp_path / "port_inplace.mp4")
    assert sample_bytes(m.audio()) == pieces[0]


def test_audio_sidecar_names_match_jax(tmp_path):
    for name in ("segment_000.avi", "marked_seg1_copy2.rawv", "x.m4s"):
        j, t = both("audio_sidecar", tmp_path / name)
        assert t == j and t.name.endswith(".audio.mp4")


# -- the MJPEG-in-MP4 reader ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mp4", "m4s"])
def test_mp4_reader_decodes_as_imdecode(avis, tmp_path, kind):
    p = tmp_path / "av.mp4"
    av_mp4(tmp4, p, avis[1], 1.0)
    if kind == "m4s":
        tmp4.fragment_mp4(p, tmp_path / "av.m4s")
        p = tmp_path / "av.m4s"
    r = open_reader(p)
    assert isinstance(r, Mp4MjpegReader) and (r.width, r.height, r.fps) == (W, H, FPS)
    got = np.concatenate([r.read_batch(4), r.read_batch(4)])
    assert r.read_batch(4) is None
    r.close()
    video = tmp4.read_mp4(p).video()
    want = []
    with open(p, "rb") as f:
        for s in video.samples:
            f.seek(s.offset)
            enc = np.frombuffer(f.read(s.size), np.uint8)
            want.append(cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(got, np.stack(want))


def test_mp4_reader_refuses_other_video_naming_the_fourcc(mp4v, tmp_path):
    with pytest.raises(IOError, match="mp4v"):
        open_reader(mp4v)
    audio_only = tmp_path / "a.mp4"
    tmp4.write_mp4(audio_only, [audio_track(tmp4, audio_payloads(0.2))])
    with pytest.raises(IOError, match="no video"):
        open_reader(audio_only)
    with pytest.raises(ValueError, match="writes frames to"):
        open_writer(tmp_path / "out.mp4", W, H)


# -- hostile input: the JAX fuzz cases, the same outcome in both --------------------------


def _outcome(mod, path):
    t0 = time.monotonic()
    try:
        res = ("parsed", file_key(mod.read_mp4(path)))
    except IOError:
        res = ("IOError", None)
    assert time.monotonic() - t0 < 5.0  # no unbounded expansion
    return res


def _same_outcome(path):
    j, t = _outcome(jmp4, path), _outcome(tmp4, path)
    assert t == j
    return t[0]


@pytest.fixture(scope="module")
def small_files(avis, tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz")
    mp4 = d / "own.mp4"
    av_mp4(tmp4, mp4, avis[0], 0.5)
    m4s = d / "own.m4s"
    tmp4.fragment_mp4(mp4, m4s)
    return mp4, m4s


def test_fuzz_truncations(small_files, tmp_path):
    raw = small_files[0].read_bytes()
    p = tmp_path / "t.mp4"
    kinds = set()
    for cut in list(range(0, len(raw), 211)) + [len(raw) - 1]:
        p.write_bytes(raw[:cut])
        kinds.add(_same_outcome(p))
    assert "IOError" in kinds


def test_fuzz_byte_flips(small_files, tmp_path):
    rng = np.random.RandomState(0)
    for src in small_files:
        raw = bytearray(src.read_bytes())
        p = tmp_path / f"f{src.suffix.lstrip('.')}.mp4"
        for _ in range(120):
            mut = bytearray(raw)
            for _ in range(rng.randint(1, 9)):
                mut[rng.randint(len(mut))] = rng.randint(256)
            p.write_bytes(bytes(mut))
            _same_outcome(p)


def test_fuzz_random_garbage(tmp_path):
    rng = np.random.RandomState(1)
    p = tmp_path / "g.mp4"
    for i in range(50):
        body = rng.randint(0, 256, rng.randint(0, 4096), dtype=np.uint8).tobytes()
        if i % 2:  # half get a plausible ftyp so parsing goes deeper
            body = b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2" + body
        p.write_bytes(body)
        assert _same_outcome(p) == "IOError"


def _patch_u32(raw, marker, field_off, value):
    pos = raw.find(marker)
    assert pos > 0
    out = bytearray(raw)
    struct.pack_into(">I", out, pos + field_off, value)
    return bytes(out)


@pytest.mark.parametrize("which,marker,off,value,want", [
    ("mp4", b"stsz", 12, 0xFFFFFFFF, "IOError"),   # stsz sample count
    ("mp4", b"stts", 12, 0x7FFFFFFF, None),        # a hostile first run of stts
    ("m4s", b"trun", 4, 0xFFFFFFFF, "IOError"),    # trun sample count
])
def test_fuzz_huge_counts(small_files, tmp_path, which, marker, off, value, want):
    src = small_files[0] if which == "mp4" else small_files[1]
    p = tmp_path / "h.mp4"
    p.write_bytes(_patch_u32(src.read_bytes(), marker, off, value))
    got = _same_outcome(p)
    assert want is None or got == want
