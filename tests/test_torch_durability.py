"""vfp_tpu_torch.workflows.durability and ``cli durability`` against
vfp_tpu.workflows.durability, on the CPU.

Input: 18 frames of 128x192 at 6 fps (the JAX CLI test's blurred-noise
content), 1 s segments: three segments of 6 frames, MJPEG at quality 95
for the segments and 90 for the marked ones.  The JAX package reads
``.avi`` through cv2's FFmpeg backend, which decodes MJPEG otherwise than
``cv2.imdecode`` (libavcodec, not libjpeg-turbo); the port decodes as
``cv2.imdecode`` does.  So the port's reports are held to the JAX reports
two ways:

- exactly, with the JAX side's ``.avi`` reads routed through
  ``cv2.imdecode`` and ``have_ffmpeg`` forced False (monkeypatch; no JAX
  file changes): every field except ``wall_seconds`` and the file paths is
  equal; ``mean_correlation`` (``dtcwtKey``) within 1e-6 (1.2e-7 measured), the float32 sums
  of two libraries (the JAX ``DtcwtKey`` with ``fast_dots=False``, the
  port's float32 math);
- at the decision level against the unpatched JAX run (its defaults):
  ``success`` and ``pattern`` per segment and ``is_successful`` equal.
"""

import json

import cv2
import numpy as np
import pytest

import vfp_tpu.fingerprint.segmenter as jsegmenter
import vfp_tpu.io.ffmpeg as jffmpeg
import vfp_tpu.io.readers as jreaders
from vfp_tpu.io.avi import avi_meta, iter_video_chunks
from vfp_tpu.wm import DctQim as JaxDctQim, DwtDctSvd as JaxDwtDctSvd
from vfp_tpu.wm.dtcwt_codecs import DtcwtKey as JaxDtcwtKey
from vfp_tpu.workflows import durability as jdur
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoWriter, ffmpeg as tffmpeg
from vfp_tpu_torch.wm import DctQim, DwtDctSvd
from vfp_tpu_torch.workflows import durability as tdur

from test_dwt_dct_svd import natural_frames as blurred_frames

H, W, FPS, N = 128, 192, 6, 18
CORR_ATOL = 1e-6
CODECS = ["dwtDctSvd", "dct", "dtcwtKey"]


class ImdecodeReader(jreaders.FrameReader):
    """The JAX package's reader protocol over ``cv2.imdecode`` of each chunk."""

    def __init__(self, file):
        meta = avi_meta(file)
        self.width, self.height, self.fps = meta["width"], meta["height"], meta["fps"]
        self._chunks = iter_video_chunks(file)

    def read_batch(self, n):
        out = []
        for chunk in self._chunks:
            out.append(cv2.imdecode(np.frombuffer(chunk, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
            if len(out) == n:
                break
        return np.stack(out) if out else None

    def close(self):
        self._chunks.close()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    path = tmp_path_factory.mktemp("dursrc") / "src.rawv"
    with RawVideoWriter(path, W, H, fps=FPS) as w:
        w.write_batch(blurred_frames(np.random.RandomState(5), b=N, h=H, w=W))
    return path


@pytest.fixture(autouse=True)
def port_without_ffmpeg(monkeypatch):
    """The port's no-ffmpeg route, whatever the host has on PATH."""
    monkeypatch.setattr(tffmpeg, "have_ffmpeg", lambda: False)


def _run_jax(codec, src, out, patched):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jffmpeg, "have_ffmpeg", lambda: False)
        mp.setattr(jsegmenter, "have_ffmpeg", lambda: False)
        mp.setattr(tffmpeg, "have_ffmpeg", lambda: False)
        if patched:
            mp.setattr(jreaders, "Cv2Reader", ImdecodeReader)
        if codec == "dtcwtKey":
            kw = {"codec": JaxDtcwtKey(fast_dots=False)} if patched else {}
            return jdur.run_durability_corr(src, out, segment_duration=1.0, **kw)
        jcodec = JaxDctQim() if codec == "dct" else JaxDwtDctSvd()
        return jdur.run_durability(src, out, segment_duration=1.0, codec=jcodec)


def _run_port(codec, src, out):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tffmpeg, "have_ffmpeg", lambda: False)
        if codec == "dtcwtKey":
            return tdur.run_durability_corr(src, out, segment_duration=1.0, device="cpu")
        tcodec = DctQim() if codec == "dct" else DwtDctSvd()
        return tdur.run_durability(src, out, segment_duration=1.0, codec=tcodec, device="cpu")


@pytest.fixture(scope="module")
def reports(source, tmp_path_factory):
    out = {}
    for codec in CODECS:
        base = tmp_path_factory.mktemp(f"dur_{codec}")
        out[codec] = {
            "port": _run_port(codec, source, base / "port"),
            "jax": _run_jax(codec, source, base / "jax", patched=True),
            "jax_cv2_ffmpeg": _run_jax(codec, source, base / "jax_ffmpeg", patched=False),
        }
    return out


def _without_paths(report):
    """The report without wall_seconds and file paths; mean correlations apart."""
    r = {k: v for k, v in report.items() if k != "wall_seconds"}
    corr = []
    for key in ("original_results", "reencoded_results"):
        rows = []
        for row in r[key]:
            row = {k: v for k, v in row.items() if k != "segment"}
            if "mean_correlation" in row:
                corr.append(row.pop("mean_correlation"))
            rows.append(row)
        r[key] = rows
    return r, np.array(corr)


@pytest.mark.parametrize("codec", CODECS)
def test_report_equals_the_jax_report_with_imdecode_reads(reports, codec):
    port, port_corr = _without_paths(reports[codec]["port"])
    jax, jax_corr = _without_paths(reports[codec]["jax"])
    assert port == jax
    np.testing.assert_allclose(port_corr, jax_corr, rtol=0, atol=CORR_ATOL)
    assert len(port_corr) == (6 if codec == "dtcwtKey" else 0)


@pytest.mark.parametrize("codec", CODECS)
def test_decisions_equal_the_unpatched_jax_run(reports, codec):
    port, jax = reports[codec]["port"], reports[codec]["jax_cv2_ffmpeg"]
    assert port["is_successful"] == jax["is_successful"]
    for key in ("original_results", "reencoded_results"):
        assert [(r["success"], r["pattern"]) for r in port[key]] == \
            [(r["success"], r["pattern"]) for r in jax[key]], key


def test_the_lossy_channel_ran_through_mjpeg_avi(reports, tmp_path_factory):
    report = reports["dwtDctSvd"]["port"]
    assert report["is_successful"] and report["original_success_rate"] == 1.0
    assert report["segment_pairs"] == 3
    for r in report["original_results"] + report["reencoded_results"]:
        assert r["segment"].endswith(".avi")
    assert reports["dtcwtKey"]["port"]["is_successful"]


def test_payload_for_segment_8bit_matches_jax():
    for i in (0, 1, 2, 7, 255, 256, 1000):
        np.testing.assert_array_equal(tdur.payload_for_segment_8bit(i),
                                      jdur.payload_for_segment_8bit(i))


def test_analyze_matches_jax_on_mixed_results():
    orig = [{"success": s, "pattern": [i], "frequency": f}
            for i, (s, f) in enumerate([(True, 1.0), (False, 0.25), (True, 0.75)])]
    re = [{"success": s, "pattern": [i], "frequency": f}
          for i, (s, f) in enumerate([(True, 0.5), (True, 1.0)])]
    port, jax = tdur._analyze(orig, re, 0.0), jdur._analyze(orig, re, 0.0)
    port.pop("wall_seconds"), jax.pop("wall_seconds")
    assert port == jax
    assert tdur._analyze([], [], 0.0)["is_successful"] is False


def test_corr_batch_fn_matches_jax_on_cpu():
    import jax.numpy as jnp
    import torch

    from vfp_tpu_torch.wm.dtcwt_codecs import DtcwtKey

    rng = np.random.RandomState(3)
    frames = blurred_frames(rng, b=3, h=64, w=96)
    jcodec, tcodec = JaxDtcwtKey(fast_dots=False), DtcwtKey()
    cap = tuple(tcodec.wm_capacity((64, 96, 3)))
    refs = np.stack([rng.randn(*cap).astype(np.float32) for _ in range(4)])
    want = np.asarray(jdur._corr_batch_fn(jcodec, refs.shape)(jnp.asarray(frames),
                                                               jnp.asarray(refs)))
    got = tdur._corr_batch_fn(tcodec, refs.shape, device="cpu")(
        torch.as_tensor(frames), torch.as_tensor(refs)).numpy()
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=CORR_ATOL)


def test_cli_prints_the_report_and_exits_on_its_verdict(source, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_cli(["durability", str(source), str(tmp_path / "dur"), "--segment-duration", "1",
                  "--quality", "95", "--device", "cpu"])
    assert e.value.code == 0
    report = json.loads(capsys.readouterr().out)
    assert report["is_successful"] and report["segment_pairs"] == 3
    assert (tmp_path / "dur" / "full.avi").exists()
    with pytest.raises(SystemExit) as e:  # a strength no mark survives: exit 1
        port_cli(["durability", str(source), str(tmp_path / "weak"), "--segment-duration", "1",
                  "--alpha", "0.5", "--device", "cpu"])
    assert e.value.code == 1
    assert json.loads(capsys.readouterr().out)["is_successful"] is False


def test_mp4_container_is_refused(source, tmp_path):
    with pytest.raises(ValueError, match="no mp4v encoder"):
        port_cli(["durability", str(source), str(tmp_path / "d"), "--container", "mp4",
                  "--device", "cpu"])
    for fn in (tdur.run_durability, tdur.run_durability_corr):
        with pytest.raises(ValueError, match="no mp4v encoder"):
            fn(source, tmp_path / "d", container="mp4", device="cpu")
    assert not (tmp_path / "d").exists()


def test_the_device_defaults_to_cuda(source, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdur.run_durability(source, tmp_path / "d")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(["durability", str(source), str(tmp_path / "d")])
