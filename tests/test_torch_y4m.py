"""vfp_tpu_torch.io.y4m against vfp_tpu.io.y4m, on the CPU.

The writer's bytes and the reader's frames must equal the JAX package's
exactly (``read_bytes()`` and ``np.array_equal``, no tolerance).  The JAX
reader upsamples chroma with ``cv2.resize`` (float32 INTER_LINEAR); the port
with ``ops/filters.py:resize_linear``, so the sizes include chroma planes of
odd width and height (W or H = 2 mod 4) and of one row or column, where a
one-ulp difference would flip a rounded byte.  Frames are seeded numpy
noise and smooth ramps.
"""

import numpy as np
import pytest

import vfp_tpu.io.y4m as jy4m
from vfp_tpu.io import open_reader as jax_open_reader, open_writer as jax_open_writer
from vfp_tpu_torch.io import Y4MReader, Y4MWriter, open_reader, open_writer

SIZES = [(48, 64), (50, 66), (46, 62), (30, 2), (2, 34), (2, 2), (120, 214)]


def frames_of(seed, n, h, w):
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 256, (n, h, w, 3))
    ramp = (np.arange(h)[:, None, None] * 3 + np.arange(w)[None, :, None] * 5
            + np.array([0, 85, 170]))[None] % 256
    half = n // 2
    out = np.concatenate([noise[:half], np.broadcast_to(ramp, (n - half, h, w, 3))])
    return out.astype(np.uint8)


def _read_all(reader):
    try:
        chunks = []
        while (b := reader.read_batch(3)) is not None:
            chunks.append(b)
        return np.concatenate(chunks), reader.fps, (reader.width, reader.height)
    finally:
        reader.close()


@pytest.mark.parametrize("h,w", SIZES)
def test_writer_bytes_and_reader_frames_equal_jax(tmp_path, h, w):
    frames = frames_of(h * 1000 + w, 5, h, w)
    with Y4MWriter(tmp_path / "port.y4m", w, h, fps=29.97) as wr:
        wr.write_batch(frames[:2])
        wr.write_batch(frames[2:])
    with jy4m.Y4MWriter(tmp_path / "jax.y4m", w, h, fps=29.97) as wr:
        wr.write_batch(frames)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()
    got, fps, size = _read_all(Y4MReader(tmp_path / "jax.y4m"))
    want, jfps, jsize = _read_all(jy4m.Y4MReader(tmp_path / "jax.y4m"))
    assert got.dtype == np.uint8 and got.shape == (5, h, w, 3)
    assert np.array_equal(got, want)
    assert (fps, size) == (jfps, jsize) == (29.97, (w, h))


def test_open_reader_and_writer_pick_y4m(tmp_path):
    frames = frames_of(3, 4, 50, 66)
    with open_writer(tmp_path / "a.y4m", 66, 50, 24.0) as wr:
        assert isinstance(wr, Y4MWriter)
        wr.write_batch(frames)
    with jax_open_writer(tmp_path / "b.y4m", 66, 50, 24.0) as wr:
        wr.write_batch(frames)
    assert (tmp_path / "a.y4m").read_bytes() == (tmp_path / "b.y4m").read_bytes()
    r = open_reader(tmp_path / "a.y4m")
    assert isinstance(r, Y4MReader)
    got, fps, _ = _read_all(r)
    want, jfps, _ = _read_all(jax_open_reader(tmp_path / "a.y4m"))
    assert np.array_equal(got, want) and fps == jfps == 24.0


HEADERS = {
    "bad chroma": b"YUV4MPEG2 W8 H8 F30:1 C444\n",
    "missing W": b"YUV4MPEG2 H8 F30:1 C420jpeg\n",
    "missing H": b"YUV4MPEG2 W8 F30:1 C420jpeg\n",
    "not y4m": b"YUV4MPEG W8 H8\n",
}


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_bad_headers_raise_in_both(tmp_path, case):
    p = tmp_path / "bad.y4m"
    p.write_bytes(HEADERS[case] + b"FRAME\n" + bytes(96))
    for cls in (jy4m.Y4MReader, Y4MReader):
        with pytest.raises(IOError):
            cls(p)


def test_bad_frame_marker_and_truncation_match_jax(tmp_path):
    frames = frames_of(8, 3, 8, 8)
    with Y4MWriter(tmp_path / "ok.y4m", 8, 8) as wr:
        wr.write_batch(frames)
    raw = (tmp_path / "ok.y4m").read_bytes()
    bad = tmp_path / "marker.y4m"
    bad.write_bytes(raw.replace(b"FRAME\n", b"FRAMX\n", 2).replace(b"FRAMX\n", b"FRAME\n", 1))
    for cls in (jy4m.Y4MReader, Y4MReader):
        r = cls(bad)
        assert r.read_batch(1).shape == (1, 8, 8, 3)
        with pytest.raises(IOError, match="frame marker"):
            r.read_batch(1)
        r.close()
    cut = tmp_path / "cut.y4m"
    cut.write_bytes(raw[:-10])  # the last frame short: two whole frames are read
    got, _, _ = _read_all(Y4MReader(cut))
    want, _, _ = _read_all(jy4m.Y4MReader(cut))
    assert got.shape[0] == 2 and np.array_equal(got, want)


def test_odd_dimensions_are_refused_by_both_writers(tmp_path):
    for cls in (jy4m.Y4MWriter, Y4MWriter):
        with pytest.raises(ValueError, match="even"):
            cls(tmp_path / "odd.y4m", 7, 8)
