"""``python -m vfp_tpu_torch.cli test-frame`` against ``python -m vfp_tpu.cli
test-frame``, on the CPU, and the pieces it stands on: the PNG reader of
colour pictures (cv2.imread's IMREAD_COLOR), the PNG writer and the
grayscale JPEG encoder (cv2.imencode of an [H, W] image).

Sizes: one 64x96 picture of smooth content (tests/test_dwt_dct_svd.py's
frames), an 8x12 watermark image.  Stated tolerance: none; the JPEG files
byte-equal to cv2's, the printed lines equal (the output paths aside).
"""

import contextlib
import io

import cv2
import numpy as np
import pytest
import torch

from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import read_image_bgr, write_png
from vfp_tpu_torch.native.jpeg import encode_jpeg_gray

from test_dwt_dct_svd import natural_frames as smooth_frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def picture(tmp_path_factory):
    d = tmp_path_factory.mktemp("tf")
    rng = np.random.RandomState(2)
    img = smooth_frames(rng, 1, 64, 96)[0]
    cv2.imwrite(str(d / "in.png"), img)
    cv2.imwrite(str(d / "wm.png"), (rng.rand(8, 12) * 255).astype(np.uint8))
    return d


def _run(cli, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(argv)
    return out.getvalue()


CASES = {
    "flagship": [],
    "dtcwtKey": ["--codec", "dtcwtKey"],
    "dct": ["--codec", "dct", "--quality", "90"],
    "grayscale_image": ["--generator", "grayscale", "--wm-image", "{d}/wm.png"],
    "dtcwtImg_image": ["--codec", "dtcwtImg", "--wm-image", "{d}/wm.png"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_test_frame_writes_the_jax_commands_files(picture, tmp_path, case):
    extra = [a.format(d=picture) for a in CASES[case]]
    text = {}
    for name, cli, flags in (("port", port_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        out = tmp_path / name
        text[name] = _run(cli, ["test-frame", str(picture / "in.png"), str(out), *extra,
                                *flags]).replace(str(out), "OUT")
    assert text["port"] == text["jax"]
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    want = {"output.jpeg", "diff.jpeg"} | ({"degenerate.jpeg"} if "image" in case else set())
    assert set(files) == want
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    if case == "flagship":
        assert "recovered payload: 01100101 (expected 01100101)" in text["port"]
    if case == "dtcwtKey":
        assert "watermark present: True" in text["port"]


def test_test_frame_reads_a_jpeg_picture(picture, tmp_path):
    img = cv2.imread(str(picture / "in.png"))
    cv2.imwrite(str(tmp_path / "in.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 97])
    text = {name: _run(cli, ["test-frame", str(tmp_path / "in.jpg"), str(tmp_path / name),
                             *flags]).replace(str(tmp_path / name), "OUT")
            for name, cli, flags in (("port", port_cli, ["--device", "cpu"]),
                                     ("jax", jax_cli, []))}
    assert text["port"] == text["jax"]
    assert ((tmp_path / "port" / "output.jpeg").read_bytes()
            == (tmp_path / "jax" / "output.jpeg").read_bytes())


def test_test_frame_never_drops_to_the_cpu(picture, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli(["test-frame", str(picture / "in.png"), str(tmp_path / "o")])


@pytest.mark.parametrize("kind", ["bgr", "bgra", "gray", "gray_alpha"])
def test_read_image_bgr_is_cv2_imread_color(tmp_path, kind):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (37, 53, 4)).astype(np.uint8)
    img[:12] = (np.add.outer(np.arange(12), np.arange(53) * 5) % 256)[..., None]
    for level in (0, 4, 9):  # cv2 picks every row filter among these
        p = tmp_path / f"{kind}{level}.png"
        if kind == "gray_alpha":  # cv2 writes no gray + alpha PNG: the port's own chunks
            _write_gray_alpha(p, img[..., :2])
        else:
            arr = {"bgr": img[..., :3], "bgra": img, "gray": img[..., 0]}[kind]
            cv2.imwrite(str(p), arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        got = read_image_bgr(p)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, cv2.imread(str(p), cv2.IMREAD_COLOR))


def _write_gray_alpha(path, ga):
    import struct
    import zlib

    from vfp_tpu_torch.io.images import PNG_SIGNATURE, _chunk

    h, w, _ = ga.shape
    raw = np.zeros((h, 2 * w + 1), np.uint8)
    raw[:, 1:] = ga.reshape(h, -1)
    path.write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0))
                     + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def test_read_image_bgr_reads_a_jpeg_and_refuses_the_rest(tmp_path):
    img = np.random.RandomState(4).randint(0, 256, (24, 40, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "a.jpg"),
                                  cv2.imread(str(tmp_path / "a.jpg")))
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    with pytest.raises(ValueError, match="PNG .* and baseline JPEG images only"):
        read_image_bgr(tmp_path / "a.bmp")
    cv2.imwrite(str(tmp_path / "deep.png"), img.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_image_bgr(tmp_path / "deep.png")


def test_png_writer_writes_rgb_and_gray(tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (21, 34, 3)).astype(np.uint8)
    write_png(tmp_path / "c.png", img)  # file order: RGB
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png"))[..., ::-1], img)
    np.testing.assert_array_equal(read_image_bgr(tmp_path / "c.png"), img[..., ::-1])
    write_png(tmp_path / "g.png", img[..., 1])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED),
                                  img[..., 1])
    for bad in (img[..., :2], img.astype(np.float32), img[:0]):
        with pytest.raises(ValueError):
            write_png(tmp_path / "x.png", bad)


@pytest.mark.parametrize("h,w", [(1, 1), (8, 8), (17, 33), (64, 96), (7, 300)])
def test_gray_jpeg_is_cv2s(h, w):
    rng = np.random.RandomState(h * w)
    img = rng.randint(0, 256, (h, w)).astype(np.uint8)
    img[: h // 2] = (np.add.outer(np.arange(h // 2), np.arange(w) * 3) % 256)
    for q in (1, 50, 90, 95, 100):
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
        assert encode_jpeg_gray(img, q) == want, q
    assert encode_jpeg_gray(img) == cv2.imencode(".jpg", img)[1].tobytes()
    with pytest.raises(ValueError):
        encode_jpeg_gray(np.zeros((4, 4, 3), np.uint8))
