"""vfp_tpu_torch's MJPEG-AVI I/O (``io/avi.py``, ``MjpegAviWriter``,
``MjpegAviReader``, ``open_reader``/``open_writer``) against vfp_tpu's, on
the CPU.

Stated tolerance: none.  The port's ``MjpegAviWriter`` writes the JAX
writer's file bytes for the same frames (its JPEGs are cv2's bytes),
``splice_mjpeg_avis`` gives the JAX splice's bytes, ``avi_meta`` matches on
both packages' files and on cv2's own MJPG file, and the port's reader
gives each chunk's ``cv2.imdecode`` pixels (RGB).  The JAX package's
``Cv2Reader`` decodes through cv2's FFmpeg backend instead, which differs
from ``cv2.imdecode``; the port reads as ``cv2.imdecode`` does.
"""

import struct

import cv2
import numpy as np
import pytest

from vfp_tpu import io as jio
from vfp_tpu.fingerprint.leak import concatenate_segments as jconcat
from vfp_tpu.io import avi as javi
from vfp_tpu_torch import io as tio
from vfp_tpu_torch.fingerprint import leak as tleak
from vfp_tpu_torch.fingerprint.marker import _read_all
from vfp_tpu_torch.io import avi as tavi
from vfp_tpu_torch.native import decode_jpegs, encode_jpeg

from torch_parity import natural_frames

H, W = 48, 64


def _write(writer_cls, path, frames, fps=6.0, quality=95, splits=(2,)):
    w = writer_cls(path, frames.shape[2], frames.shape[1], fps=fps, quality=quality)
    start = 0
    for end in (*splits, len(frames)):
        w.write_batch(frames[start:end])
        start = end
    w.close()
    return path


def _imdecode_all(path):
    return np.stack([cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
                     for c in javi.iter_video_chunks(path)])


def _read(reader, n=3):
    out = []
    try:
        while (b := reader.read_batch(n)) is not None:
            out.append(b)
    finally:
        reader.close()
    return np.concatenate(out)


@pytest.mark.parametrize("shape", [(H, W), (17, 33), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality,fps", [(95, 6.0), (75, 29.97), (90, 30.0)])
def test_writer_bytes_equal_the_jax_writer(tmp_path, shape, quality, fps):
    frames = natural_frames(np.random.RandomState(quality), 5, *shape)
    port = _write(tio.MjpegAviWriter, tmp_path / "p.avi", frames, fps, quality, splits=(1, 3))
    jax = _write(jio.MjpegAviWriter, tmp_path / "j.avi", frames, fps, quality, splits=(4,))
    assert port.read_bytes() == jax.read_bytes()
    assert tavi.avi_meta(port) == javi.avi_meta(jax)


def test_open_writer_routes_avi_to_mjpeg_at_its_quality(tmp_path):
    frames = natural_frames(np.random.RandomState(2), 3, H, W)
    with tio.open_writer(tmp_path / "p.avi", W, H, 6.0, 80) as w:
        assert isinstance(w, tio.MjpegAviWriter)
        w.write_batch(frames)
    with jio.open_writer(tmp_path / "j.avi", W, H, 6.0, 80) as w:
        w.write_batch(frames)
    assert (tmp_path / "p.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()


def test_reader_on_a_jax_file_equals_imdecode_per_chunk(tmp_path):
    frames = natural_frames(np.random.RandomState(4), 7, H, W)
    path = _write(jio.MjpegAviWriter, tmp_path / "j.avi", frames, 12.0, 90)
    r = tio.open_reader(path)
    assert isinstance(r, tio.MjpegAviReader)
    assert (r.width, r.height, r.fps) == (W, H, 12.0)
    got = _read(r)
    np.testing.assert_array_equal(got, _imdecode_all(path))
    got, fps = _read_all(path)
    np.testing.assert_array_equal(got, _imdecode_all(path))
    assert fps == 12.0


def test_meta_and_reader_on_a_cv2_videowriter_file(tmp_path):
    frames = natural_frames(np.random.RandomState(5), 5, H, W)
    path = str(tmp_path / "cv2.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 6.0, (W, H))
    assert vw.isOpened()
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    assert tavi.avi_meta(path) == javi.avi_meta(path)
    assert tavi.avi_meta(path)["mjpeg"]
    np.testing.assert_array_equal(_read(tio.MjpegAviReader(path), 2), _imdecode_all(path))


def test_chunk_walk_matches_the_jax_walk(tmp_path):
    frames = natural_frames(np.random.RandomState(6), 4, H, W)
    path = _write(jio.MjpegAviWriter, tmp_path / "j.avi", frames)
    assert list(tavi.iter_video_chunks(path)) == list(javi.iter_video_chunks(path))
    assert list(tavi.iter_video_chunk_spans(path)) == list(javi.iter_video_chunk_spans(path))


def _segments(tmp_path, writer_cls, prefix, shapes=((H, W),) * 3):
    segs = []
    for i, shape in enumerate(shapes):
        frames = natural_frames(np.random.RandomState(10 + i), 3 + i, *shape)
        segs.append(_write(writer_cls, tmp_path / f"{prefix}{i}.avi", frames, 6.0, 90))
    return segs


def test_splice_bytes_equal_the_jax_splice(tmp_path):
    segs = _segments(tmp_path, tio.MjpegAviWriter, "s")
    assert tavi.splice_mjpeg_avis(segs, tmp_path / "port.avi") is True
    assert javi.splice_mjpeg_avis(segs, tmp_path / "jax.avi") is True
    assert (tmp_path / "port.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()
    want = [c for s in segs for c in tavi.iter_video_chunks(s)]
    assert list(tavi.iter_video_chunks(tmp_path / "port.avi")) == want


def test_concatenate_segments_stream_copies_avi_as_jax(tmp_path):
    segs = _segments(tmp_path, tio.MjpegAviWriter, "s")
    tleak.concatenate_segments(segs, tmp_path / "port.avi")
    jconcat(segs, tmp_path / "jax.avi")
    assert (tmp_path / "port.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()


def test_splice_refusals_match_jax(tmp_path):
    mixed = _segments(tmp_path, tio.MjpegAviWriter, "m", shapes=((H, W), (32, W)))
    bad = tmp_path / "x.avi"
    bad.write_bytes(b"definitely not RIFF")
    whole = _segments(tmp_path, tio.MjpegAviWriter, "t", shapes=((H, W),))[0]
    cut = tmp_path / "cut.avi"
    cut.write_bytes(whole.read_bytes()[: whole.stat().st_size // 2])  # inside movi
    for inputs in (mixed, [bad], [cut]):
        assert tavi.splice_mjpeg_avis(inputs, tmp_path / "o.avi") is False
        assert javi.splice_mjpeg_avis(inputs, tmp_path / "oj.avi") is False
        assert not (tmp_path / "o.avi").exists() and not (tmp_path / "oj.avi").exists()


def test_a_frame_splice_of_rawv_into_avi_encodes_once(tmp_path):
    frames = natural_frames(np.random.RandomState(8), 4, H, W)
    segs = []
    for i in range(2):
        p = tmp_path / f"s{i}.rawv"
        with tio.RawVideoWriter(p, W, H, 6.0) as w:
            w.write_batch(frames[2 * i: 2 * i + 2])
        segs.append(p)
    tleak.concatenate_segments(segs, tmp_path / "leak.avi")
    jax = _write(jio.MjpegAviWriter, tmp_path / "j.avi", frames, 6.0, 95)
    assert (tmp_path / "leak.avi").read_bytes() == jax.read_bytes()


def test_the_4gib_refusal(tmp_path):
    w = tio.MjpegAviWriter(tmp_path / "big.avi", W, H)

    class Huge:  # a file already just under the RIFF limit
        def __init__(self, f):
            self.f = f

        def tell(self):
            return 0xFFFF_F000 - 100

        def __getattr__(self, name):
            return getattr(self.f, name)

    w.f = Huge(w.f)
    with pytest.raises(IOError, match="4 GiB"):
        w.write_encoded(b"\xff\xd8" + bytes(200) + b"\xff\xd9")
    w.f = w.f.f
    w.close()


@pytest.mark.parametrize("name", ["clip.mp4", "clip.y4m", "clip.mkv", "clip"])
def test_other_containers_are_refused(tmp_path, name):
    """A suffix the port neither reads nor writes is refused both ways; an
    ``.mp4`` is read (MJPEG video) but frames are never written to one, and
    ``.y4m`` goes both ways."""
    path = tmp_path / name
    if name.endswith(".y4m"):
        with tio.open_writer(path, W, H) as w:
            assert isinstance(w, tio.Y4MWriter)
        r = tio.open_reader(path)
        assert isinstance(r, tio.Y4MReader)
        r.close()
        return
    with pytest.raises(ValueError, match=r"writes frames to \.rawv, \.avi, \.y4m files only"):
        tio.open_writer(path, W, H)
    if name.endswith(".mp4"):
        with pytest.raises(FileNotFoundError):  # the suffix is taken; there is no file
            tio.open_reader(path)
    else:
        with pytest.raises(ValueError, match=r"reads \.rawv, \.avi, \.mp4, \.m4s, \.y4m files"):
            tio.open_reader(path)


def test_corrupt_avi_files_raise_ioerror(tmp_path):
    frames = natural_frames(np.random.RandomState(9), 4, H, W)
    raw = _write(tio.MjpegAviWriter, tmp_path / "a.avi", frames).read_bytes()
    p = tmp_path / "t.avi"
    for cut in [0, 7, 11, 100, 300, len(raw) // 2, len(raw) - 1]:
        p.write_bytes(raw[:cut])
        try:
            got = _read(tio.open_reader(p), 2)
        except IOError:
            continue
        assert got.shape[1:] == (H, W, 3)  # a whole-chunk prefix decodes
    not_mjpeg = bytearray(raw)
    at = raw.index(b"vidsMJPG") + 4
    not_mjpeg[at:at + 4] = b"H264"
    p.write_bytes(bytes(not_mjpeg))
    with pytest.raises(IOError, match="MJPEG"):
        tio.open_reader(p)
    p.write_bytes(b"RIFF" + struct.pack("<I", 4) + b"WAVE")
    with pytest.raises(IOError, match="not an AVI"):
        _read_all(p)


def test_flipped_jpeg_bytes_decode_or_raise_ioerror():
    """Corrupt chunk data never crashes the native decoder: each flipped
    chunk decodes to a frame or raises IOError."""
    frames = natural_frames(np.random.RandomState(11), 1, H, W)
    raw = encode_jpeg(frames[0], 90)
    frng = np.random.RandomState(7)
    for _ in range(300):
        mut = bytearray(raw)
        for _ in range(frng.randint(1, 9)):
            mut[frng.randint(len(mut))] = frng.randint(256)
        try:
            out = decode_jpegs([bytes(mut)], H, W)
        except IOError:
            continue
        assert out.shape == (1, H, W, 3)
