"""The DT-CWT image codec and its image payloads in vfp_tpu_torch against
vfp_tpu and cv2, on the CPU.

The JAX codec is built with ``fast_dots=False``, as in the ``dtcwtKey``
parity tests.  Stated tolerances:

- ``GrayScale``/``DeGrayScale`` and ``BlockShuffler.generate_wm``: equal
  (the watermark thresholds at 127 after two INTER_LINEAR resizes, which
  the port computes bit for bit as cv2's default branch does);
- ``DeBlockShuffler.degenerate``: atol 1e-4 of JAX (payload scale 0-255),
  both ``antialias`` modes; the cv2-free INTER_AREA and INTER_LINEAR
  resizes against ``cv2.resize``: atol 1e-4 (they are equal on every case
  here);
- the PNG reader and writer: equal, both ways, with cv2;
- ``DtcwtImg.mark_frames`` against the JAX codec, as the ``dtcwtKey``
  tests: the fused kernel path (480x640) >= 99.5% of pixels identical, the
  rest within 1; the glue paths (236x318, 239x317) >= 99.9%, within 2;
- ``extract_frames`` against the JAX codec's op-by-op decode
  (``_decode_channel_raw``): max abs difference <= 1.5e-6 of the planes'
  largest magnitude (a relative bound: the normalised masks are <= 1, so
  the planes reach about 1,600);
- ``backend="kernel"`` on the CPU (the kernels' plain versions) against
  ``backend="torch"``: >= 99.99% of marked pixels identical, within 1, and
  the planes within the same relative 1.5e-6;
- the CLI round trip against the JAX CLI: marked frames >= 99.9% identical;
  recovered PNGs >= 99.9% of pixels equal, the rest within 1.
"""

import re
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.ops.color import bgr_to_yuv as jax_bgr_to_yuv
from vfp_tpu.wm import dtcwt_codecs as jcodecs, payload as jpayload, payload_img as jpimg
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter, read_png_gray, write_png_gray
from vfp_tpu_torch.io.images import PNG_SIGNATURE
from vfp_tpu_torch.ops import filters as tfilters
from vfp_tpu_torch.utils import VfpConfig, make_codec
from vfp_tpu_torch.wm import (BlockShuffler, DeBlockShuffler, DeGrayScale, DtcwtImg, DtcwtKey,
                              GrayScale)

from torch_parity import natural_frames

torch.set_num_threads(1)
JAX_CODEC = jcodecs.DtcwtImg(fast_dots=False)


def _np(x):
    return np.asarray(x)


def _payload_image(rng, shape, kind):
    """A payload image: a random 8-bit image, a 0/255 logo, or flat 127/128
    regions (values right at the generator's threshold)."""
    img = rng.randint(0, 256, shape).astype(np.float32)
    if kind == "logo":
        return np.where(img > 128, 255, 0).astype(np.float32)
    if kind == "flat":
        img = np.full(shape, 127, np.float32)
        img[shape[0] // 3:, shape[1] // 2:] = 128
    return img


# -- GrayScale / DeGrayScale --------------------------------------------------------

@pytest.mark.parametrize("cap", [(64, 64), (1, 500), (37, 41)])
def test_grayscale_matches_jax(rng, cap):
    img = rng.randint(0, 256, (12, 10))
    want = jpayload.GrayScale(5).generate_wm(img, cap)
    got = GrayScale(5).generate_wm(img, cap)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    planes = (want.reshape(1, -1) + rng.rand(3, want.size) * 0.6 - 0.3).astype(np.float32)
    deg = DeGrayScale(5).set_shape((12, 10))
    out = deg.degenerate_batch(torch.from_numpy(planes)).numpy()
    jdeg = jpayload.DeGrayScale(5).set_shape((12, 10))
    np.testing.assert_array_equal(out, _np(jdeg.degenerate_batch(jnp.asarray(planes))))
    assert out.dtype == np.uint8 and out.shape == (3, 12, 10)
    np.testing.assert_array_equal(deg.degenerate(planes[0]), jdeg.degenerate(planes[0]))


# -- BlockShuffler / DeBlockShuffler and the resizes ------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (27, 48), (100, 120), (135, 240), (50, 33)])
@pytest.mark.parametrize("kind", ["random", "logo", "flat"])
def test_block_shuffler_wm_is_array_equal_to_jax(rng, shape, kind):
    img = _payload_image(rng, shape, kind)
    for key in (0, 7):
        for cap in [(136, 240), (30, 40), (68, 120), (101, 81), (60, 108)]:
            want = jpimg.BlockShuffler(key).generate_wm(img, cap)
            got = BlockShuffler(key).generate_wm(img, cap)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("payload_shape", [(64, 64), (27, 48), (256, 256)])
def test_deblock_shuffler_matches_jax(rng, antialias, payload_shape):
    plane = (rng.randn(136, 240) * 100).astype(np.float32)
    got = DeBlockShuffler(3).set_shape(payload_shape).degenerate(plane, antialias=antialias)
    want = jpimg.DeBlockShuffler(3).set_shape(payload_shape).degenerate(plane,
                                                                        antialias=antialias)
    assert got.shape == want.shape == payload_shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the block permutation round-trips
    x = rng.rand(135, 240).astype(np.float32)
    shuffled = BlockShuffler(3).randomize_channel(x, 3, (35, 30))
    np.testing.assert_array_equal(DeBlockShuffler(3).derandomize_channel(shuffled, 3, (35, 30)), x)


RESIZES = [((135, 240), (27, 48)), ((135, 240), (45, 80)), ((136, 240), (68, 120)),
           ((135, 240), (64, 64)), ((135, 240), (67, 120)), ((135, 240), (100, 300)),
           ((135, 240), (256, 256)), ((7, 9), (3, 4)), ((64, 64), (135, 240)),
           ((1080, 1920), (136, 240)), ((2, 2), (5, 7))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                                                  for s, d in RESIZES])
def test_resizes_match_cv2(rng, src, dst):
    img = (rng.rand(*src) * 510 - 255).astype(np.float32)
    np.testing.assert_allclose(tfilters.resize_area(img, dst),
                               cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tfilters.resize_linear(img, dst),
                               cv2.resize(img, (dst[1], dst[0])), atol=1e-4, rtol=0)


# -- the PNG reader and writer ----------------------------------------------------------

def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _png_with_filter(img, kind):
    """An 8-bit gray PNG whose every row uses filter ``kind`` (0-4)."""
    rows, prev = [], np.zeros(img.shape[1], int)
    for row in img.astype(int):
        left = np.concatenate([[0], row[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prev = row
    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 0, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


@pytest.fixture
def gray_image(rng):
    img = (np.add.outer(np.arange(57), np.arange(91) * 3) % 256).astype(np.uint8)
    img[10:30, 20:70] = rng.randint(0, 256, (20, 50))
    return img


def test_png_reader_reads_cv2_gray_pngs(tmp_path, gray_image):
    for level in range(10):
        p = tmp_path / f"cv2_{level}.png"
        cv2.imwrite(str(p), gray_image, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(read_png_gray(p), gray_image)


@pytest.mark.parametrize("kind", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_png_reader_undoes_every_filter(tmp_path, gray_image, kind):
    p = tmp_path / "f.png"
    p.write_bytes(_png_with_filter(gray_image, kind))
    np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), gray_image)
    np.testing.assert_array_equal(read_png_gray(p), gray_image)


def test_png_writer_is_read_back_by_cv2(tmp_path, gray_image):
    p = tmp_path / "port.png"
    write_png_gray(p, gray_image)
    np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), gray_image)
    np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_GRAYSCALE), gray_image)
    np.testing.assert_array_equal(read_png_gray(p), gray_image)
    with pytest.raises(ValueError):
        write_png_gray(p, gray_image.astype(np.float32))


def test_png_reader_refuses_what_it_does_not_read(tmp_path, gray_image):
    color = tmp_path / "color.png"
    cv2.imwrite(str(color), np.dstack([gray_image] * 3))
    with pytest.raises(ValueError, match="8-bit grayscale"):
        read_png_gray(color)
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), gray_image.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png_gray(deep)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_gray(bad)
    broken = bytearray(_png_with_filter(gray_image, 1))
    broken[40] ^= 0xFF  # inside the IDAT data: its CRC no longer holds
    bad.write_bytes(bytes(broken))
    with pytest.raises(ValueError, match="CRC"):
        read_png_gray(bad)


# -- the codec --------------------------------------------------------------------------

def test_codec_config_and_reference():
    assert DtcwtImg() == DtcwtImg(alpha=1.5, step=5.0, normalize_masks=True)
    assert DtcwtImg.from_reference(jcodecs.DtcwtImg()) == DtcwtImg()
    assert DtcwtImg.from_reference(jcodecs.DtcwtImg(alpha=2.0, step=4.0)) == DtcwtImg(2.0, 4.0)
    assert DtcwtKey.from_reference(jcodecs.DtcwtImg()) == DtcwtKey(alpha=1.5,
                                                                   normalize_masks=True)
    cfg = VfpConfig()
    cfg.codec.alpha_img, cfg.codec.step = 2.5, 4.0
    for name in ("dtcwtImg", "dtcwt_img"):
        assert make_codec(name, cfg) == DtcwtImg(alpha=2.5, step=4.0)
    assert make_codec("dtcwtImg") == DtcwtImg()
    assert DtcwtImg().wm_capacity((1080, 1920, 3)) == (136, 240)


def _frames_and_wm(rng, h, w):
    f = natural_frames(rng, 2, h, w)
    img = _payload_image(rng, (64, 64), "random")
    wm = jpimg.BlockShuffler(0).generate_wm(img, JAX_CODEC.wm_capacity((h, w, 3)))
    return f, wm.astype(np.float32)


def _op_by_op_decode(frames):
    yuv = jax_bgr_to_yuv(jnp.asarray(frames, jnp.float32))
    return _np(JAX_CODEC._decode_channel_raw(yuv[..., 0], yuv[..., 1]))


SHAPES = [(480, 640, 0.995, 1), (236, 318, 0.999, 2), (239, 317, 0.999, 2)]


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("h,w,frac,most", SHAPES, ids=[f"{h}x{w}" for h, w, _, _ in SHAPES])
def test_mark_and_extract_match_jax(rng, backend, h, w, frac, most):
    f, wm = _frames_and_wm(rng, h, w)
    want = _np(JAX_CODEC.mark_frames(jnp.asarray(f), jnp.asarray(wm)))
    codec = DtcwtImg(backend=backend)
    got = codec.mark_frames(torch.from_numpy(f), torch.from_numpy(wm)).numpy()
    d = np.abs(got.astype(int) - want)
    assert got.dtype == np.uint8 and got.shape == f.shape
    assert (d == 0).mean() >= frac and d.max() <= most, ((d == 0).mean(), d.max())
    planes = codec.extract_frames(torch.from_numpy(np.array(want))).numpy()
    ref = _op_by_op_decode(want)
    assert planes.shape == ref.shape == (2, *JAX_CODEC.wm_capacity((h, w, 3)))
    assert np.abs(planes - ref).max() <= 1.5e-6 * np.abs(ref).max()


def test_masks_are_normalised_after_the_guard(rng):
    """The image variant divides by max(12, amax) per subband plane, after
    the decoder's 0 -> 0.01 guard: a black frame's masks are all 0, so its
    guarded masks are 0.01 / 12 (plain DtcwtKey: 0.01)."""
    m = torch.tensor(rng.randint(0, 30, (2, 6, 4, 5)).astype(np.float32))
    m[0, 0] = 0
    m[1, 2] = torch.tensor(rng.randint(0, 5, (4, 5)).astype(np.float32))
    img = DtcwtImg()._finish_masks(m.clone(), zero_guard=True)
    guarded = torch.where(m == 0, torch.full_like(m, 0.01), m)
    peak = guarded.amax(dim=(-2, -1), keepdim=True)
    torch.testing.assert_close(img, guarded / torch.clamp(peak, min=12.0), rtol=0, atol=0)
    assert torch.all(img[0, 0] == np.float32(0.01) / np.float32(12.0))
    assert torch.equal(DtcwtKey()._finish_masks(m.clone(), zero_guard=True), guarded)
    torch.testing.assert_close(DtcwtImg()._finish_masks(m.clone()),
                               m / torch.clamp(m.amax(dim=(-2, -1), keepdim=True), min=12.0),
                               rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(480, 640), (236, 318)])
def test_kernel_backend_on_the_cpu_matches_the_torch_backend(rng, h, w):
    f, wm = _frames_and_wm(rng, h, w)
    x, plane = torch.from_numpy(f), torch.from_numpy(wm)
    a = DtcwtImg(backend="kernel").mark_frames(x, plane).numpy()
    b = DtcwtImg(backend="torch").mark_frames(x, plane).numpy()
    d = np.abs(a.astype(int) - b)
    assert (d == 0).mean() >= 0.9999 and d.max() <= 1
    pa = DtcwtImg(backend="kernel").extract_frames(torch.from_numpy(a)).numpy()
    pb = DtcwtImg(backend="torch").extract_frames(torch.from_numpy(a)).numpy()
    assert np.abs(pa - pb).max() <= 1.5e-6 * np.abs(pb).max()


def test_recovered_image_agrees_with_the_payload_at_1080p(rng):
    """The bar of tests/test_dtcwt.py's 1080p image round trip: the
    recovered plane, unscrambled with INTER_AREA, agrees with the payload's
    bits at > 0.8."""
    from test_dwt_dct_svd import natural_frames as smooth_frames

    codec = DtcwtImg()
    frames = smooth_frames(rng, b=1, h=1080, w=1920)
    img = (rng.rand(27, 48) > 0.5).astype(np.float32) * 255
    wm = BlockShuffler(key=5).generate_wm(img, codec.wm_capacity((1080, 1920, 3)))
    marked = codec.mark_frames(torch.from_numpy(frames), torch.from_numpy(wm.astype(np.float32)))
    plane = codec.extract_frames(marked).numpy()[0]
    out = DeBlockShuffler(key=5).set_shape(img.shape).degenerate(plane, antialias=True)
    agreement = ((out > out.mean()) == (img > 127)).mean()
    assert agreement > 0.8, agreement


# -- the CLI against the JAX CLI --------------------------------------------------------

def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(1000)
    finally:
        r.close()


def test_cli_image_round_trip_matches_the_jax_cli(rng, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")
    src, jax_out, port_out = (tmp_path / n for n in ("src.rawv", "jax.rawv", "port.rawv"))
    with RawVideoWriter(src, 320, 240, fps=6) as w:
        w.write_batch(natural_frames(rng, 4, 240, 320))
    image = tmp_path / "payload.png"
    write_png_gray(image, _payload_image(rng, (48, 64), "logo").astype(np.uint8))
    flags = ["--codec", "dtcwtImg", "--batch-size", "2"]
    jax_cli(["mark", str(src), str(jax_out), *flags, "--wm-image", str(image)])
    port_cli(["mark", str(src), str(port_out), *flags, "--wm-image", str(image),
              "--device", "cpu"])
    assert "marked 4 frames" in capsys.readouterr().out
    a, b = _read(jax_out), _read(port_out)
    assert a.shape == b.shape == (4, 240, 320, 3) and (a == b).mean() >= 0.999
    shape = ["--wm-height", "48", "--wm-width", "64"]
    jax_cli(["detect", str(jax_out), *flags, "--out-dir", str(tmp_path / "jdet"), *shape])
    jax_lines = capsys.readouterr().out
    port_cli(["detect", str(jax_out), *flags, "--out-dir", str(tmp_path / "tdet"), *shape,
              "--device", "cpu"])
    port_lines = capsys.readouterr().out
    assert re.sub(r"\S*det/", "", jax_lines) == re.sub(r"\S*det/", "", port_lines)
    assert "recovered 4 watermark images" in port_lines
    for i in range(4):
        want = cv2.imread(str(tmp_path / "jdet" / f"wm_{i:04d}.png"), cv2.IMREAD_GRAYSCALE)
        got = read_png_gray(tmp_path / "tdet" / f"wm_{i:04d}.png")
        d = np.abs(got.astype(int) - want)
        assert got.shape == (48, 64) and (d == 0).mean() >= 0.999 and d.max() <= 1


def test_cli_grayscale_generator_with_a_bit_codec_matches_the_jax_cli(rng, tmp_path, capsys,
                                                                        monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")
    src, jax_out, port_out = (tmp_path / n for n in ("src.rawv", "jax.rawv", "port.rawv"))
    with RawVideoWriter(src, 96, 64, fps=6) as w:
        w.write_batch(natural_frames(rng, 4, 64, 96))
    image = tmp_path / "bits.png"
    cv2.imwrite(str(image), np.array([[0, 255, 255, 0, 0, 255, 0, 255]], np.uint8))
    flags = ["--generator", "grayscale", "--wm-image", str(image), "--batch-size", "2"]
    jax_cli(["mark", str(src), str(jax_out), *flags])
    port_cli(["mark", str(src), str(port_out), *flags, "--device", "cpu"])
    a, b = _read(jax_out), _read(port_out)
    assert (a == b).mean() >= 0.999
    capsys.readouterr()
    jax_cli(["detect", str(jax_out), "--payload-len", "8"])
    want = capsys.readouterr().out
    port_cli(["detect", str(port_out), "--payload-len", "8", "--device", "cpu"])
    got = capsys.readouterr().out
    line = [ln for ln in got.splitlines() if ln.startswith("majority payload")]
    assert line and line == [ln for ln in want.splitlines() if ln.startswith("majority payload")]
