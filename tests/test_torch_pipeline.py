"""vfp_tpu_torch.pipeline and its CLI against vfp_tpu, on the CPU.

The JAX pipelines take the full-frame path (VFP_LOWLINK=0), the port's
counterpart.  Stated tolerance: marked u8 identical on >= 99.9% of pixels
(the plain torch path vs the XLA path); payloads identical.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vfp_tpu import pipeline as jpipe
from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.wm import DeShuffler as JaxDeShuffler, DwtDctSvd as JaxCodec
from vfp_tpu_torch import pipeline as tpipe
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter
from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd

from torch_parity import PAYLOAD, natural_frames, spread_wm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96


@pytest.fixture(autouse=True)
def full_frame_jax_path(monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")


@pytest.fixture(scope="module")
def source_video(tmp_path_factory):
    p = tmp_path_factory.mktemp("torchsrc") / "source.rawv"
    with RawVideoWriter(p, W, H, fps=6) as w:
        w.write_batch(natural_frames(np.random.RandomState(11), 10, H, W))
    return p


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(1000)
    finally:
        r.close()


def test_frame_marker_partial_batch_matches_jax(rng):
    frames = natural_frames(rng, 3, H, W)  # 3 < batch 4: padded, then cut back
    wm = spread_wm(H, W)
    want = jpipe.FrameMarker(JaxCodec(), wm, batch_size=4).mark(frames)
    got = tpipe.FrameMarker(DwtDctSvd(), wm, batch_size=4, device="cpu").mark(frames)
    assert got.shape == want.shape == frames.shape
    assert (got == want).mean() >= 0.999


def test_multi_marker_matches_jax(rng):
    frames = natural_frames(rng, 3, H, W)
    wms = [spread_wm(H, W, payload=PAYLOAD), spread_wm(H, W, payload=1 - PAYLOAD)]
    want = jpipe.MultiMarker(JaxCodec(), wms, batch_size=4).mark_all(frames)
    mm = tpipe.MultiMarker(DwtDctSvd(), wms, batch_size=4, device="cpu")
    got = mm.mark_all(frames)
    assert mm.n_variants == 2
    assert got.shape == want.shape == (2, 3, H, W, 3)
    assert (got == want).mean() >= 0.999


def test_frame_extractor_partial_batch_matches_jax(rng):
    frames = jpipe.FrameMarker(JaxCodec(), spread_wm(H, W), batch_size=4).mark(
        natural_frames(rng, 3, H, W))
    want = jpipe.FrameExtractor(
        JaxCodec(), JaxDeShuffler(0, "fixed").set_shape((8,)), batch_size=4).extract(frames)
    got = tpipe.FrameExtractor(
        DwtDctSvd(), DeShuffler(0, "fixed").set_shape((8,)), batch_size=4,
        device="cpu").extract(frames)
    assert got.dtype == np.uint8 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(PAYLOAD, (3, 1)))


def test_cached_bit_extractor_is_keyed_by_codec_and_device():
    a = tpipe.cached_bit_extractor(DwtDctSvd(), 0, 8, device="cpu")
    assert tpipe.cached_bit_extractor(DwtDctSvd(), 0, 8, device=torch.device("cpu")) is a
    assert tpipe.cached_bit_extractor(DwtDctSvd(scales=(0, 20, 0)), 0, 8, device="cpu") is not a
    assert a.device == torch.device("cpu") and a.degenerator.payload_len == 8


def test_embedder_and_extractor_drive_a_stream(rng):
    from vfp_tpu.io import ArrayReader, ArrayWriter

    frames = natural_frames(rng, 7, H, W)
    writer = ArrayWriter()
    marker = tpipe.FrameMarker(DwtDctSvd(), spread_wm(H, W), batch_size=3, device="cpu")
    stats = tpipe.Embedder(ArrayReader(frames), marker, writer).start()
    assert stats.frames == 7 and stats.fps > 0
    np.testing.assert_array_equal(writer.frames, marker.mark(frames))
    ext = tpipe.FrameExtractor(DwtDctSvd(), DeShuffler(0, "fixed").set_shape((8,)),
                               batch_size=3, device="cpu")
    res = tpipe.Extractor(ArrayReader(writer.frames), ext).start()
    pattern, freq = res.majority()
    assert res.frames == 7 and freq == 1.0
    np.testing.assert_array_equal(pattern, PAYLOAD)


def test_embedder_raises_a_marker_error_and_stops_its_threads(rng):
    from vfp_tpu.io import ArrayReader, ArrayWriter

    class Broken:
        batch_size = 1

        def mark(self, frames):
            raise RuntimeError("boom")

    reader = ArrayReader(natural_frames(rng, 6, 16, 16))
    with pytest.raises(RuntimeError, match="boom"):
        tpipe.Embedder(reader, Broken(), ArrayWriter(), prefetch=1).start()


def test_cli_matches_the_jax_cli(source_video, tmp_path, capsys):
    jax_out, port_out = tmp_path / "jax.rawv", tmp_path / "port.rawv"
    jax_cli(["mark", str(source_video), str(jax_out), "--batch-size", "4"])
    port_cli(["mark", str(source_video), str(port_out), "--batch-size", "4", "--device", "cpu"])
    assert "marked 10 frames" in capsys.readouterr().out
    a, b = _read(jax_out), _read(port_out)
    assert a.shape == b.shape == (10, H, W, 3)
    assert (a == b).mean() >= 0.999

    jax_cli(["detect", str(jax_out), "--payload-len", "8", "--batch-size", "4"])
    jax_lines = capsys.readouterr().out
    port_cli(["detect", str(port_out), "--payload-len", "8", "--batch-size", "4",
              "--device", "cpu"])
    port_lines = capsys.readouterr().out
    majority = "majority payload: 01100101 (frequency 1.00)"
    assert majority in jax_lines and majority in port_lines
    port_cli(["detect", str(port_out), "--payload", "01100101", "--device", "cpu"])
    assert "matches expected payload: True" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # wrong expectation -> exit 1
        port_cli(["detect", str(port_out), "--payload", "11111111", "--device", "cpu"])
    assert e.value.code == 1


def test_cli_never_drops_to_the_cpu(source_video, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(["mark", str(source_video), str(tmp_path / "o.rawv")])  # default: cuda
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(["detect", str(source_video), "--device", "cuda"])


def test_port_imports_neither_jax_nor_cv2(source_video, tmp_path):
    """A fresh interpreter runs the port's CLI end to end without importing jax or cv2."""
    code = f"""
import sys
import vfp_tpu_torch, vfp_tpu_torch.kernels, vfp_tpu_torch.pipeline
from vfp_tpu_torch.cli import main
main(["mark", {str(source_video)!r}, {str(tmp_path / 'm.rawv')!r}, "--device", "cpu"])
main(["detect", {str(tmp_path / 'm.rawv')!r}, "--payload", "01100101", "--device", "cpu"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cv2"))
assert not bad, bad
print("NO_JAX_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout and "matches expected payload: True" in r.stdout
