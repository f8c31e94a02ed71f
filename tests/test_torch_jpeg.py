"""vfp_tpu_torch.native.jpeg (the native library's ``jpeg.cpp``) against cv2's
libjpeg-turbo, on the CPU.

The port's encoder must write the bytes ``cv2.imencode('.jpg', bgr,
[IMWRITE_JPEG_QUALITY, q])`` writes for the BGR view of the same RGB frame,
and its decoder must give the pixels ``cv2.imdecode(..., IMREAD_COLOR)``
gives (in RGB), on the port's bytes and on cv2's, including cv2's 4:4:4
and restart-interval files.  Stated tolerance: none, bytes and pixels equal.
Anything else the decoder meets (progressive, arithmetic coding, 12-bit,
other sampling factors, a component count other than 3, truncated or
foreign data) raises IOError naming it.
"""

import hashlib

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from vfp_tpu_torch.native import decode_jpeg, decode_jpegs, encode_jpeg, encode_jpegs

import chip_smoke
from torch_parity import natural_frames

QUALITIES = [1, 50, 75, 90, 95, 100]
SHAPES = [(1, 1), (7, 9), (8, 8), (16, 16), (17, 33), (67, 101), (64, 96), (240, 320)]
CONTENTS = ["natural", "noise", "flat", "saturated"]
# SHA-256 of the q90 JPEG of natural_frames(RandomState(14), 1, 1080, 1920)[0]:
# cv2.imencode's bytes here, and the port's on any machine (chip_smoke.py checks it
# on the GPU machine, whose g++ differs)
JPEG_1080P_Q90_SHA256 = "8b3645f4734eba2d5dfbac6afd16a62eee1022dc8c4a1d565593f512166fd15e"


def _frame(content, h, w, seed=0):
    rng = np.random.RandomState(seed)
    if content == "natural":
        return natural_frames(rng, 1, h, w)[0]
    if content == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if content == "flat":
        return np.broadcast_to(rng.randint(0, 256, 3).astype(np.uint8), (h, w, 3)).copy()
    return (rng.randint(0, 2, (h, w, 3)) * 255).astype(np.uint8)  # saturated


def cv2_encode(rgb, quality, *params):
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, quality, *params])
    assert ok
    return enc.tobytes()


def cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _assert_codec_matches_cv2(rgb, quality):
    ours, theirs = encode_jpeg(rgb, quality), cv2_encode(rgb, quality)
    assert ours == theirs, (len(ours), len(theirs))
    got = decode_jpeg(ours)
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    np.testing.assert_array_equal(got, cv2_decode(theirs))


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_bytes_and_pixels_equal_cv2(quality, shape, content):
    _assert_codec_matches_cv2(_frame(content, *shape, seed=quality), quality)


@pytest.mark.parametrize("quality", [90, 95])
def test_a_1080p_frame_equals_cv2(quality):
    _assert_codec_matches_cv2(natural_frames(np.random.RandomState(14), 1, 1080, 1920)[0],
                              quality)


def test_the_pinned_1080p_digest():
    frame = chip_smoke.natural_frames(np.random.RandomState(14), 1, 1080, 1920)[0]
    ours = encode_jpeg(frame, 90)
    assert hashlib.sha256(ours).hexdigest() == JPEG_1080P_Q90_SHA256
    assert hashlib.sha256(cv2_encode(frame, 90)).hexdigest() == JPEG_1080P_Q90_SHA256
    assert chip_smoke.JPEG_1080P_Q90_SHA256 == JPEG_1080P_Q90_SHA256


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(1, 100),
       seed=st.integers(0, 2**31 - 1), content=st.sampled_from(CONTENTS))
def test_property_any_shape_and_quality_equals_cv2(h, w, quality, seed, content):
    _assert_codec_matches_cv2(_frame(content, h, w, seed), quality)


@pytest.mark.parametrize("params", [
    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 2, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
], ids=["444", "rst1", "rst3", "444-rst2", "optimized-tables"])
@pytest.mark.parametrize("shape", [(1, 1), (17, 33), (67, 101), (240, 320)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cv2_files_of_other_layouts_decode_as_cv2(params, shape):
    for quality, content in ((75, "natural"), (100, "noise")):
        data = cv2_encode(_frame(content, *shape, seed=quality), quality, *params)
        np.testing.assert_array_equal(decode_jpeg(data), cv2_decode(data))


def _strip_dht(data: bytes) -> bytes:
    """The JPEG without its DHT segments, as an AVI1 MJPEG chunk carries it."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + data[pos:])


def test_a_chunk_without_huffman_tables_takes_the_standard_ones():
    data = cv2_encode(_frame("natural", 67, 101), 90)
    bare = _strip_dht(data)
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    np.testing.assert_array_equal(decode_jpeg(bare), cv2_decode(data))


def test_batches_run_in_order_on_the_pool():
    frames = natural_frames(np.random.RandomState(3), 9, 40, 56)
    chunks = encode_jpegs(frames, 85)
    assert chunks == [cv2_encode(f, 85) for f in frames]
    got = decode_jpegs(chunks, 40, 56)
    assert got.shape == (9, 40, 56, 3)
    for g, c in zip(got, chunks):
        np.testing.assert_array_equal(g, cv2_decode(c))
    assert encode_jpegs(frames[:1], 85) == chunks[:1]


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    b = bytearray(data)
    b[data.index(marker) + offset] = value
    return bytes(b)


def _refusals():
    rgb = _frame("natural", 32, 48)
    base = cv2_encode(rgb, 90)
    gray = cv2.imencode(".jpg", rgb[..., 0])[1].tobytes()
    return {
        "progressive": (cv2_encode(rgb, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), "progressive"),
        "sampling 4:2:2": (cv2_encode(rgb, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422), "sampling"),
        "sampling 4:1:1": (cv2_encode(rgb, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411), "sampling"),
        "one component": (gray, "1 components"),
        "arithmetic": (_patched(base, b"\xff\xc0", 1, 0xC9), "arithmetic"),
        "12-bit": (_patched(base, b"\xff\xc0", 4, 12), "12-bit"),
        "not a JPEG": (b"\x89PNG\r\n" + base[6:], "not a JPEG"),
        "empty": (b"", "not a JPEG"),
        "truncated header": (base[:300], "truncated"),
        "truncated data": (base[:-200], "truncated"),
        "no scan": (base[:2] + b"\xff\xd9", "no image data"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_what_the_decoder_does_not_take_raises_ioerror(case):
    data, what = _refusals()[case]
    with pytest.raises(IOError, match=what):
        decode_jpeg(data)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((70000, 1, 3), np.uint8))
    data = cv2_encode(_frame("flat", 8, 8), 90)
    with pytest.raises(IOError, match="expected"):
        decode_jpegs([data], 8, 16)
