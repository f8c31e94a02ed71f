"""vfp_tpu_torch.io, .native and .utils.config against their vfp_tpu originals.

The port keeps its own copies of these JAX-free modules.  Stated tolerance:
none; ``.rawv`` files round-trip byte for byte in both directions, and the
configuration dataclasses serialise to the same dictionaries.
"""

import json

import numpy as np
import pytest

from vfp_tpu import io as jio
from vfp_tpu.utils import config as jconfig
from vfp_tpu_torch import io as tio
from vfp_tpu_torch.native import NativeRawVideoReader, NativeRawVideoWriter, build as tbuild
from vfp_tpu_torch.utils import config as tconfig

from torch_parity import natural_frames

H, W = 24, 40


@pytest.fixture
def frames(rng):
    return natural_frames(rng, 5, H, W)


def _read_all(reader):
    try:
        out = []
        while (b := reader.read_batch(2)) is not None:
            out.append(b)
        return np.concatenate(out)
    finally:
        reader.close()


@pytest.mark.parametrize("port_reader", [tio.RawVideoReader, NativeRawVideoReader])
def test_rawv_from_the_jax_writer_reads_back_identically(tmp_path, frames, port_reader):
    path = tmp_path / "jax.rawv"
    with jio.RawVideoWriter(path, W, H, fps=24) as w:
        w.write_batch(frames)
    r = port_reader(path)
    assert (r.width, r.height, r.fps) == (W, H, 24.0)
    got = _read_all(r)
    assert got.dtype == np.uint8 and got.tobytes() == frames.tobytes()


@pytest.mark.parametrize("port_writer", [tio.RawVideoWriter, NativeRawVideoWriter])
def test_rawv_from_the_port_writer_reads_back_identically(tmp_path, frames, port_writer):
    path = tmp_path / "port.rawv"
    w = port_writer(path, W, H, 29.97)
    w.write_batch(frames[:3])
    w.write(frames[3])
    w.write_batch(frames[4:])
    w.close()
    jax_bytes = tmp_path / "jax.rawv"
    with jio.RawVideoWriter(jax_bytes, W, H, fps=29.97) as jw:
        jw.write_batch(frames)
    assert path.read_bytes() == jax_bytes.read_bytes()
    got = _read_all(jio.RawVideoReader(path))
    assert got.tobytes() == frames.tobytes()


def test_open_reader_and_writer_take_rawv_only(tmp_path, frames):
    """Frames are never written to ``.mp4`` (the JAX writer there is cv2's
    mp4v) and other suffixes are refused both ways; besides ``.rawv`` the
    port reads and writes MJPEG ``.avi`` (the JAX writer's bytes, each frame
    decoded as ``cv2.imdecode`` decodes it) and ``.y4m`` (tests/test_torch_y4m.py),
    and reads MJPEG ``.mp4`` (tests/test_torch_mp4.py)."""
    with pytest.raises(ValueError, match=r"writes frames to \.rawv, \.avi, \.y4m files only"):
        tio.open_writer(tmp_path / "clip.mp4", W, H)
    for name in ("clip.mkv", "clip.webm"):
        with pytest.raises(ValueError, match=r"reads \.rawv, \.avi, \.mp4, \.m4s, \.y4m files"):
            tio.open_reader(tmp_path / name)
        with pytest.raises(ValueError, match=r"writes frames to \.rawv, \.avi, \.y4m files"):
            tio.open_writer(tmp_path / name, W, H)
    import cv2
    from vfp_tpu.io.avi import iter_video_chunks

    with tio.open_writer(tmp_path / "clip.avi", W, H, 24, 90) as w:
        assert isinstance(w, tio.MjpegAviWriter)
        w.write_batch(frames)
    with jio.MjpegAviWriter(tmp_path / "jax.avi", W, H, 24, 90) as jw:
        jw.write_batch(frames)
    assert (tmp_path / "clip.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()
    r = tio.open_reader(tmp_path / "clip.avi")
    assert isinstance(r, tio.MjpegAviReader) and (r.width, r.height, r.fps) == (W, H, 24.0)
    want = [cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
            for c in iter_video_chunks(tmp_path / "jax.avi")]
    np.testing.assert_array_equal(_read_all(r), np.stack(want))


def test_open_uses_the_native_engine_where_it_builds(tmp_path, frames, monkeypatch):
    path = tmp_path / "a.rawv"
    w = tio.open_writer(path, W, H, 24)
    w.write_batch(frames)
    w.close()
    r = tio.open_reader(path)
    assert _read_all(r).tobytes() == frames.tobytes()
    want = NativeRawVideoReader if tbuild.have_native() else tio.RawVideoReader
    assert type(r) is want

    from vfp_tpu_torch import native

    monkeypatch.setattr(native, "have_native", lambda: False)  # no g++: pure Python
    r = tio.open_reader(path)
    assert type(r) is tio.RawVideoReader and _read_all(r).tobytes() == frames.tobytes()
    assert type(tio.open_writer(tmp_path / "b.rawv", W, H)) is tio.RawVideoWriter


def test_native_library_builds_beside_the_port_only():
    if not tbuild.have_native():
        pytest.skip("no g++ to build the native engine")
    tbuild.load_vfpio()
    path = tbuild.library_path()
    assert path.exists()
    assert path.parts[-5:-2] == ("build", "vfp_tpu_torch", "native")
    root = tbuild.BUILD_ROOT.parents[2]
    assert root / "build" in path.parents and root / "vfp_tpu" not in path.parents


def test_truncated_and_foreign_files_are_refused(tmp_path, frames):
    path = tmp_path / "t.rawv"
    with tio.RawVideoWriter(path, W, H) as w:
        w.write_batch(frames[:1])
    path.write_bytes(path.read_bytes()[:-5])
    with pytest.raises(IOError, match="truncated"):
        tio.RawVideoReader(path).read_batch(1)
    bad = tmp_path / "bad.rawv"
    bad.write_bytes(b"NOTRAWV0" + bytes(40))
    for reader in (tio.RawVideoReader, NativeRawVideoReader):
        with pytest.raises(IOError, match="not a VFP raw video file"):
            reader(bad)


def test_array_reader_and_writer(frames):
    r, w = tio.ArrayReader(frames, fps=12), tio.ArrayWriter()
    while (b := r.read_batch(2)) is not None:
        w.write_batch(b)
    assert (r.width, r.height, r.fps) == (W, H, 12)
    np.testing.assert_array_equal(w.frames, frames)
    assert tio.ArrayReader(frames[:1]).read().shape == (H, W, 3)


def test_config_copy_matches_the_jax_config(tmp_path):
    assert tconfig.VfpConfig().to_dict() == jconfig.VfpConfig().to_dict()
    d = {"codec": {"alpha_dct": 31.0, "fast_dots": True, "backend": "pallas"},
         "workflow": {"copies": 5}, "serve": {"port": 9000}}
    assert tconfig.VfpConfig.from_dict(d).to_dict() == jconfig.VfpConfig.from_dict(d).to_dict()
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(jconfig.VfpConfig.from_dict(d).to_dict()))
    loaded = tconfig.VfpConfig.load(path)
    assert loaded.codec.alpha_dct == 31.0 and loaded.workflow.copies == 5
    assert loaded.to_dict() == jconfig.VfpConfig.load(path).to_dict()
