"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Every test needs a CUDA GPU and skips without one.  This file imports no
jax (the GPU machine has none), so it runs there without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the DT-CWT image codec's mask normalisation equal; its
extract on the card against the CPU's kernel path within 3e-5 of the
planes' largest magnitude; the DT-CWT masks, the delta synthesis, the six full-transform
DT-CWT kernels, the level-1 u8 lowpasses, the flagship and DCT-QIM marks,
the DCT-QIM extract and the Y mean (an exact fixed-point sum), the three
QIM block kernels on SoA blocks, the flagship kernels' integer bodies and,
at the tile edges, the highpass-only LeGall synthesis equal (max_abs_err
0); other float outputs rtol/atol 2e-5 (the kernels and
their plain versions share one op order, IEEE division and no FMA; the
detect kernels at 480x856 atol 1e-5); the DT-CWT extract on
the card against the CPU's kernel path atol 1e-4 (PyTorch's complex
division may round otherwise); other u8 outputs identical on >= 99.5% of
pixels and bits on >= 99.9% (a borderline s0 may take the other,
parity-equivalent QIM bin).  The DCT-QIM mark gets the same means as its
plain version, so the comparison isolates the kernel.
"""

import numpy as np
import pytest
import torch

from vfp_tpu_torch import kernels
from vfp_tpu_torch.kernels import dtcwt_delta as tdd, dtcwt_level1 as tdl, dtcwt_masks as tdm
from vfp_tpu_torch.kernels import dtcwt_synthesis as tds
from vfp_tpu_torch.kernels import fused_dct_qim as tdq, fused_embed as tfe, qim as tqim
from vfp_tpu_torch.ops.color import bgr_to_yuv
from vfp_tpu_torch.wm import (BlockShuffler, CorrShuffler, DctQim, DeCorrShuffler, DeShuffler,
                              DtcwtImg, DtcwtKey, DwtDctSvd, Shuffler, block_grid,
                              clear_wm_cache)

from torch_parity import PAYLOAD, cuda_device, natural_frames  # noqa: F401

SCALE = 15.0
DETECT_KERNELS = ("dtcwt_level1_ll_color", "dtcwt_qshift_ll", "dtcwt_qshift_hp",
                  "dtcwt_legall_synthesis_hp")
NEW_DTCWT = ("dtcwt_level1_analysis_ll", "dtcwt_qshift_analysis", "dtcwt_qshift_synthesis",
             "dtcwt_qshift_synthesis_ll", "dtcwt_legall_synthesis", "dtcwt_legall_synthesis_ll")
EQUAL = ("dtcwt_qshift_masks", "dtcwt_delta_synthesis", "dtcwt_level1_ll_y",
         "dtcwt_level1_ll_color", "fused_mark_planar", "fused_dct_qim_mark", "y_dc_mean",
         "fused_dct_qim_extract", "qim_triplet_soa", "qim_decode_soa", "qim_embed_soa")
SYNTHESIS_PLANES = {"dtcwt_qshift_synthesis": 16, "dtcwt_qshift_synthesis_ll": 4,
                    "dtcwt_legall_synthesis": 16, "dtcwt_legall_synthesis_ll": 4}


def _wm(h, w, device):
    wm = Shuffler(key=0).generate_wm(PAYLOAD, (1, h * w // 64))
    return torch.as_tensor(np.asarray(wm, np.float32).reshape(-1), device=device)


def _payloads(bits):
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    return deg.degenerate_batch(bits).cpu().numpy()


def _inputs(name, device, rng, h, w):
    if name in ("dtcwt_level1_ll_y", "dtcwt_level1_ll_color"):
        return (torch.as_tensor(natural_frames(rng, 2, h, w), device=device),)
    if name in ("dtcwt_qshift_ll", "dtcwt_qshift_hp"):  # the level-1 (or -2) lowpasses
        ll4 = rng.rand(2, 4, h // 4 * 2, w // 4 * 2).astype(np.float32) * 200
        return (torch.as_tensor(ll4, device=device),)
    if name == "dtcwt_legall_synthesis_hp":  # the folded level-3 coefficients
        return (torch.as_tensor(rng.randn(2, 12, h // 8, w // 8).astype(np.float32),
                                device=device),)
    if name in ("dtcwt_level1_analysis", "dtcwt_level1_analysis_ll"):
        return (torch.as_tensor(rng.rand(2, h, w).astype(np.float32) * 255, device=device),)
    if name == "dtcwt_qshift_analysis":
        ll4 = rng.rand(2, 4, h // 4 * 2, w // 4 * 2).astype(np.float32) * 200
        return (torch.as_tensor(ll4, device=device),)
    if name in SYNTHESIS_PLANES:  # level-3-sized planes: odd rows at every shape
        planes = rng.randn(2, SYNTHESIS_PLANES[name], h // 8, w // 8).astype(np.float32)
        return (torch.as_tensor(planes, device=device),)
    if name == "dtcwt_qshift_masks":
        ll4 = rng.rand(2, 4, h // 8 * 4, w // 8 * 4).astype(np.float32) * 200
        return (torch.as_tensor(ll4, device=device), 5.0)
    if name == "dtcwt_delta_synthesis":
        return (torch.as_tensor(rng.randn(2, 12, h // 8, w // 8).astype(np.float32),
                                device=device),)
    if name in ("fused_dct_qim_mark", "fused_dct_qim_extract", "y_dc_mean"):
        h8 = h // 8 * 8  # the DCT-QIM kernels take H, W % 8 == 0
        frames = torch.as_tensor(natural_frames(rng, 2, h8, w), device=device)
        planes = frames.permute(0, 3, 1, 2)
        if name == "y_dc_mean":
            return (planes,)
        if name == "fused_dct_qim_extract":
            return (planes, 20.0)
        means = tdq.y_dc_mean_reference(planes)
        wm2d = _wm(h8, w, device)[: (h8 // 8) * (w // 8)].reshape(h8 // 8, w // 8).contiguous()
        return (planes, wm2d, 20.0, means)
    if name.startswith("fused"):
        frames = torch.as_tensor(natural_frames(rng, 2, h, w), device=device)
        (nbh, nbw), _ = block_grid((h, w))
        wm2d = _wm(h, w, device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
        planes = frames.permute(0, 3, 1, 2)
        return (planes, wm2d, SCALE, 1) if name == "fused_mark_planar" else (planes, SCALE, 1)
    m = torch.as_tensor(rng.rand(2, 16, h * w // 64).astype(np.float32) * 300, device=device)
    wm = torch.as_tensor(rng.randint(0, 2, m.shape[2]).astype(np.float32), device=device)
    return {"qim_triplet_soa": (m,), "qim_decode_soa": (m, SCALE),
            "qim_embed_soa": (m, wm, SCALE)}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(72, 128), (40, 856), (78, 128)])
@pytest.mark.parametrize("name", [k.__name__ for k in kernels.KERNELS])
def test_kernel_matches_plain_version(cuda_device, name, h, w):
    args = _inputs(name, cuda_device, np.random.RandomState(h * w), h, w)
    kernels.reset_launch_counts()
    got = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == 1
    module = next(m for m in (tdq, tfe, tqim, tdd, tdl, tdm, tds) if hasattr(m, name))
    want = getattr(module, name + "_reference")(*args)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == r.shape and g.dtype == r.dtype
        if name in EQUAL or name in NEW_DTCWT:  # one op order: equal
            assert torch.equal(g, r)
        elif g.dtype == torch.uint8:
            assert (g == r).float().mean() >= 0.995
        elif name.endswith("extract_planar"):
            assert (g == r).float().mean() >= 0.999
        else:
            torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (1, 33), (3, 1), (2, 4005), (16, 32265), (64, 32265)])
def test_qim_kernels_equal_plain_versions_at_grid_edges(cuda_device, b, n):
    """The QIM kernels' flat grid over B * N blocks: B = 1, N = 1 (a block
    of threads with one live thread), N = 33 and N % 4 != 0 (a frame
    boundary inside a warp), the 1918-wide path's N = 32265 at B = 16 and
    at B = 64 (16,133 blocks of threads); blocks at 1e-3, 1 and 300 and
    zero, sub-eps and Frobenius-underflow blocks (each eps guard of the
    triplet) among them."""
    rng = np.random.RandomState(b * 100003 + n)
    m = rng.rand(b, 16, n).astype(np.float32) * rng.choice(
        np.float32([1e-3, 1.0, 300.0]), (b, 1, n))
    m[:, :, ::7] = 0
    m[:, :, 3::11] *= np.float32(1e-22)
    m[:, :, 5::13] *= np.float32(1e-15)
    m = torch.as_tensor(m, device=cuda_device)
    wm = torch.as_tensor(rng.randint(0, 2, n).astype(np.float32), device=cuda_device)
    kernels.reset_launch_counts()
    got = (tqim.qim_triplet_soa(m), tqim.qim_decode_soa(m, SCALE), tqim.qim_embed_soa(m, wm, SCALE))
    torch.cuda.synchronize()
    assert all(kernels.launch_counts()[k] == 1
               for k in ("qim_triplet_soa", "qim_decode_soa", "qim_embed_soa"))
    want = (tqim.qim_triplet_soa_reference(m), tqim.qim_decode_soa_reference(m, SCALE),
            tqim.qim_embed_soa_reference(m, wm, SCALE))
    for g, r in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert g.shape == r.shape and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,mark_kernel,extract_kernel", [
    (72, 128, "fused_mark_planar", "fused_extract_planar"),
    (71, 126, "qim_triplet_soa", "qim_decode_soa"),  # W % 4 != 0: the SoA kernels
])
def test_codec_on_the_card_takes_the_kernels(cuda_device, h, w, mark_kernel, extract_kernel):
    frames = torch.as_tensor(natural_frames(np.random.RandomState(1), 3, h, w), device=cuda_device)
    codec = DwtDctSvd()  # auto: kernels for CUDA tensors
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, _wm(h, w, cuda_device))
    bits = codec.extract_frames(marked)
    counts = kernels.launch_counts()
    assert counts[mark_kernel] == 1 and counts[extract_kernel] == 1, counts
    assert marked.shape == frames.shape and marked.dtype == torch.uint8
    assert (_payloads(bits) == PAYLOAD).all()
    plain = DwtDctSvd(backend="kernel").mark_frames(frames.cpu(), _wm(h, w, "cpu"))
    assert (marked.cpu() == plain).float().mean() >= 0.995


@pytest.mark.cuda
def test_two_channel_codec_takes_qim_embed(cuda_device):
    frames = torch.as_tensor(natural_frames(np.random.RandomState(2), 2, 72, 128),
                             device=cuda_device)
    codec = DwtDctSvd(scales=(5.0, 15.0, 0.0))
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, _wm(72, 128, cuda_device))
    assert kernels.launch_counts()["qim_embed_soa"] == 2
    assert (_payloads(codec.extract_frames(marked)) == PAYLOAD).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(72, 136), (32, 856)])
def test_dct_codec_on_the_card_takes_the_kernels(cuda_device, h, w):
    frames = torch.as_tensor(natural_frames(np.random.RandomState(3), 3, h, w), device=cuda_device)
    codec = DctQim()  # auto: kernels for CUDA tensors
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, _wm(h, w, cuda_device))
    bits = codec.extract_frames(marked)
    counts = kernels.launch_counts()
    assert (counts["fused_dct_qim_mark"], counts["fused_dct_qim_extract"],
            counts[kernels.EXTRACT_DECIDE], counts["y_dc_mean"]) == (1, 1, 1, 1), counts
    assert marked.shape == frames.shape and marked.dtype == torch.uint8
    assert (_payloads(bits) == PAYLOAD).all()
    plain = DctQim(backend="kernel").mark_frames(frames.cpu(), _wm(h, w, "cpu"))
    assert (marked.cpu() == plain).float().mean() >= 0.999


@pytest.mark.cuda
def test_dct_kernels_take_contiguous_planes_too(cuda_device):
    """Planes that are not an interleaved view take the kernels' strided path."""
    rng = np.random.RandomState(4)
    planes = torch.as_tensor(natural_frames(rng, 2, 64, 128), device=cuda_device)
    planes = planes.permute(0, 3, 1, 2).contiguous()
    wm2d = torch.as_tensor(rng.randint(0, 2, (8, 16)).astype(np.float32), device=cuda_device)
    means = tdq.y_dc_mean(planes)
    assert torch.equal(means, tdq.y_dc_mean_reference(planes))
    got = tdq.fused_dct_qim_mark(planes, wm2d, 20.0, means)
    assert got.stride() == planes.stride()
    want = tdq.fused_dct_qim_mark_reference(planes, wm2d, 20.0, means)
    assert (got == want).float().mean() >= 0.999
    bits = tdq.fused_dct_qim_extract(got, 20.0)
    assert torch.equal(bits, tdq.fused_dct_qim_extract_reference(got, 20.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", DETECT_KERNELS)
def test_detect_kernel_matches_plain_version_at_480x856(cuda_device, name):
    args = _inputs(name, cuda_device, np.random.RandomState(6), 480, 856)
    got = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    want = getattr(tdl if hasattr(tdl, name) else tds, name + "_reference")(*args)
    assert got.shape == want.shape
    if name in EQUAL:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_masks_and_qshift_read_the_level1_halves_in_place(cuda_device):
    """``ll[:, 0]`` and ``ll[:, 1]`` of the [B, 2, 4, h, w] level-1 output go
    to the kernels by batch stride, with the results of contiguous copies."""
    frames = torch.as_tensor(natural_frames(np.random.RandomState(7), 3, 240, 320),
                             device=cuda_device)
    ll = tdl.dtcwt_level1_ll_color(frames)
    for half in (ll[:, 0], ll[:, 1]):
        assert not half.is_contiguous()
        assert torch.equal(tdm.dtcwt_qshift_masks(half), tdm.dtcwt_qshift_masks(half.contiguous()))
        assert torch.equal(tdl.dtcwt_qshift_ll(half), tdl.dtcwt_qshift_ll(half.contiguous()))
        assert torch.equal(tdl.dtcwt_qshift_hp(half), tdl.dtcwt_qshift_hp(half.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(240, 320), (480, 856)])
def test_dtcwt_key_mark_on_the_card_takes_the_kernels(cuda_device, h, w):
    frames = torch.as_tensor(natural_frames(np.random.RandomState(5), 2, h, w), device=cuda_device)
    codec = DtcwtKey()  # auto: kernels for CUDA tensors
    wm = torch.as_tensor(CorrShuffler(0).generate_wm(None, codec.wm_capacity((h, w, 3))),
                         device=cuda_device)
    clear_wm_cache()  # the spectrum is computed once per distinct plane
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, wm)
    counts = kernels.launch_counts()
    assert all(counts[k] == 1 for k in ("dtcwt_level1_ll_y", "dtcwt_qshift_masks",
                                        "dtcwt_delta_synthesis", "dtcwt_level1_analysis")), counts
    assert marked.shape == frames.shape and marked.dtype == torch.uint8
    plain = DtcwtKey(backend="kernel").mark_frames(frames.cpu(), wm.cpu())
    assert (marked.cpu() == plain).float().mean() >= 0.999
    kernels.reset_launch_counts()
    planes = codec.extract_frames(marked)
    counts = kernels.launch_counts()
    assert all(counts[k] == 1 for k in (*DETECT_KERNELS, "dtcwt_qshift_masks")), counts
    assert sum(counts.values()) == 5, counts
    assert planes.shape == (2, *codec.wm_capacity((h, w, 3)))
    want = DtcwtKey(backend="kernel").extract_frames(marked.cpu())
    torch.testing.assert_close(planes.cpu(), want, rtol=0, atol=1e-4)
    corr = DeCorrShuffler(0).correlation_batch(planes)
    assert bool((corr > 0.1).all()), corr


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(804, 1920), (204, 328), (239, 317), (64, 128)])
def test_dtcwt_key_off_the_fused_geometry_takes_the_kernels(cuda_device, h, w):
    """uint8 frames whose H or W is not a multiple of 8 (804x1920, 204x328),
    odd frames (239x317, the bgr_to_yuv path) and float frames (64x128) mark
    and extract on the card through the kernels alone, equal to the same
    path with every kernel's plain version on the CPU."""
    rng = np.random.RandomState(h + w)
    frames = torch.as_tensor(natural_frames(rng, 2, h, w), device=cuda_device)
    if (h, w) == (64, 128):
        frames = frames.to(torch.float32)
    codec = DtcwtKey()
    wm = torch.as_tensor(CorrShuffler(0).generate_wm(None, codec.wm_capacity((h, w, 3))),
                         device=cuda_device)
    clear_wm_cache()
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, wm)
    planes = codec.extract_frames(marked.to(frames.dtype))
    counts = kernels.launch_counts()
    u8_even = frames.dtype == torch.uint8 and h % 2 == 0 and w % 2 == 0
    fused = h % 8 == 0 and w % 8 == 0
    want = {"dtcwt_level1_ll_y": u8_even, "dtcwt_level1_ll_color": u8_even,
            "dtcwt_level1_analysis_ll": not u8_even,
            "dtcwt_qshift_masks": fused, "dtcwt_delta_synthesis": fused,
            "dtcwt_qshift_synthesis": not fused, "dtcwt_qshift_synthesis_ll": not fused,
            "dtcwt_legall_synthesis_ll": not fused}
    for name, ran in want.items():
        assert (counts[name] > 0) == ran, (name, counts)
    assert marked.shape == frames.shape and marked.dtype == torch.uint8
    plain = DtcwtKey(backend="kernel")
    want_marked = plain.mark_frames(frames.cpu(), wm.cpu())
    assert (marked.cpu() == want_marked).float().mean() >= 0.999
    torch.testing.assert_close(planes.cpu(), plain.extract_frames(marked.cpu().to(frames.dtype)),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_dtcwt_img_mask_normalisation_is_exact_on_the_card(cuda_device):
    """The image codec's glue: the 0 -> 0.01 guard, then m / max(12, amax)
    per subband plane, a division by a tensor: equal on the card and on the
    CPU (no reciprocal multiply), for peaks above and below 12."""
    rng = np.random.RandomState(3)
    m = torch.as_tensor(rng.randint(0, 30, (3, 6, 17, 30)).astype(np.float32))
    m[0, 1] = 0
    m[1, 4] = torch.as_tensor(rng.randint(0, 6, (17, 30)).astype(np.float32))
    codec = DtcwtImg()
    for guard in (False, True):
        got = codec._finish_masks(m.to(cuda_device), zero_guard=guard).cpu()
        torch.testing.assert_close(got, codec._finish_masks(m, zero_guard=guard), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(240, 320), (204, 328), (239, 317)])
def test_dtcwt_img_on_the_card_takes_the_kernels(cuda_device, h, w):
    """DtcwtImg marks and extracts on the card through the same kernels as
    DtcwtKey (fused at 240x320, the glue and the three syntheses at 204x328,
    bgr_to_yuv and level 1 lowpass-only at 239x317), equal to the plain
    kernel path on the CPU: marked u8 >= 99.9%, planes within 3e-5 of their
    largest magnitude (the normalised masks scale them to about 1,600)."""
    rng = np.random.RandomState(h * w)
    frames = torch.as_tensor(natural_frames(rng, 2, h, w), device=cuda_device)
    codec = DtcwtImg()
    payload = (rng.rand(27, 48) > 0.5).astype(np.float32) * 255
    wm = torch.as_tensor(BlockShuffler(5).generate_wm(payload, codec.wm_capacity((h, w, 3))),
                         dtype=torch.float32, device=cuda_device)
    clear_wm_cache()
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, wm)
    planes = codec.extract_frames(marked)
    counts = kernels.launch_counts()
    fused = h % 8 == 0 and w % 8 == 0
    u8_even = h % 2 == 0 and w % 2 == 0
    want = {"dtcwt_level1_ll_y": u8_even, "dtcwt_level1_ll_color": u8_even,
            "dtcwt_qshift_masks": fused, "dtcwt_delta_synthesis": fused,
            "dtcwt_qshift_synthesis": not fused, "dtcwt_legall_synthesis_hp": True}
    for name, ran in want.items():
        assert (counts[name] > 0) == ran, (name, counts)
    plain = DtcwtImg(backend="kernel")
    assert (marked.cpu() == plain.mark_frames(frames.cpu(), wm.cpu())).float().mean() >= 0.999
    ref = plain.extract_frames(marked.cpu())
    err = float((planes.cpu() - ref).abs().max())
    assert err <= 3e-5 * float(ref.abs().max()), (err, float(ref.abs().max()))


@pytest.mark.cuda
def test_transform_at_four_levels_on_the_card(cuda_device):
    """forward -> inverse and forward_raw -> inverse_raw at 4 levels of an
    odd-sized batch on the kernels: equal to the plain transform, and a
    reconstruction within 2e-3 on 0-255 values."""
    from vfp_tpu_torch.ops.dtcwt import Transform2d

    x = torch.as_tensor(np.random.RandomState(9).rand(3, 134, 250).astype(np.float32) * 255,
                        device=cuda_device)
    t, plain = Transform2d("kernel"), Transform2d("torch")
    kernels.reset_launch_counts()
    pyr = t.forward(x, nlevels=4)
    rec = t.inverse(pyr)
    counts = kernels.launch_counts()
    assert (counts["dtcwt_level1_analysis"], counts["dtcwt_qshift_analysis"],
            counts["dtcwt_qshift_synthesis"], counts["dtcwt_legall_synthesis"]) == (1, 3, 3, 1)
    want = plain.forward(x, nlevels=4)
    assert torch.equal(pyr.lowpass, want.lowpass)
    assert all(torch.equal(a, b) for a, b in zip(pyr.highpasses, want.highpasses))
    assert torch.equal(rec, plain.inverse(want))
    torch.testing.assert_close(rec, x, rtol=0, atol=2e-3)
    planes, sizes = t.forward_raw(x, nlevels=4)
    torch.testing.assert_close(t.inverse_raw(planes, sizes), x, rtol=0, atol=2e-3)


# The kernels redesigned for Hopper (tiled level 1; the q-shift template that
# all three q-shift modes share) at the shapes their edge paths take: planes
# smaller than one tile, q-shift levels smaller than the 13-sample halo
# (the circular index wraps more than once), output widths not a multiple of
# 4 (no vector stores), B = 1 and B = 32, and both level-1 tile heights.
LEVEL1_SHAPES = [(1, 2, 2), (1, 6, 10), (2, 18, 22), (1, 136, 238), (1, 136, 240),
                 (32, 24, 40), (32, 72, 136), (4, 720, 1280)]
QSHIFT_SHAPES = [(1, 4, 2, 4), (1, 4, 8, 8), (2, 4, 10, 10), (2, 4, 30, 118), (32, 4, 24, 40),
                 (3, 4, 90, 160), (1, 4, 540, 960)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LEVEL1_SHAPES)
def test_level1_analysis_equals_plain_version_at_edge_shapes(cuda_device, shape):
    x = torch.as_tensor(np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32) * 255,
                        device=cuda_device)
    got = tdl.dtcwt_level1_analysis(x)
    torch.cuda.synchronize()
    want = tdl.dtcwt_level1_analysis_reference(x)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape", QSHIFT_SHAPES)
@pytest.mark.parametrize("name", ["dtcwt_qshift_analysis", "dtcwt_qshift_ll", "dtcwt_qshift_hp"])
def test_qshift_kernels_equal_plain_versions_at_edge_shapes(cuda_device, name, shape, strided):
    """``strided``: the input is ``planes[:, :4]`` of a [B, 16, h, w] level,
    read in place by its batch stride (for B = 1 that view is contiguous)."""
    b, _, h, w = shape
    rng = np.random.RandomState(b * h + w)
    planes = torch.as_tensor(rng.randn(b, 16 if strided else 4, h, w).astype(np.float32) * 50,
                             device=cuda_device)
    x = planes[:, :4]
    assert x.is_contiguous() == (not strided or b == 1)
    got = getattr(tdl, name)(x)
    torch.cuda.synchronize()
    want = getattr(tdl, name + "_reference")(x)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())


# The LeGall synthesis tile (32 x 64 outputs from a 19 x 35 input window;
# the full, lowpass-only and highpass-only modes share its template) and the
# masks tile (8 x 24 mask outputs from a 46 x 116 level-1 window) at their
# edges: planes smaller than one tile and than the halo (the circular index
# wraps more than once; the masks of a 4 x 4 plane are one output), odd h
# and w (2w % 4 != 0: no vector store), grids that are not a multiple of the
# tile, B = 1 and B = 32, and the masks' batch-strided input.
LEGALL_SHAPES = [(1, 1, 1), (1, 1, 2), (2, 3, 5), (1, 17, 33), (2, 16, 32), (32, 20, 40),
                 (3, 33, 65), (1, 360, 640)]
LEGALL_PLANES = {"dtcwt_legall_synthesis": 16, "dtcwt_legall_synthesis_ll": 4,
                 "dtcwt_legall_synthesis_hp": 12}
MASKS_SHAPES = [(1, 4, 4), (2, 36, 100), (32, 68, 104), (1, 132, 196), (3, 540, 960)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LEGALL_SHAPES)
@pytest.mark.parametrize("name", list(LEGALL_PLANES))
def test_legall_kernels_equal_plain_versions_at_edge_shapes(cuda_device, name, shape):
    b, h, w = shape
    rng = np.random.RandomState(b * h + w)
    x = torch.as_tensor(rng.randn(b, LEGALL_PLANES[name], h, w).astype(np.float32) * 50,
                        device=cuda_device)
    got = getattr(tds, name)(x)
    torch.cuda.synchronize()
    want = getattr(tds, name + "_reference")(x)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape", MASKS_SHAPES)
def test_masks_kernel_equals_plain_version_at_edge_shapes(cuda_device, shape, strided):
    """``strided``: the input is ``ll[:, 0]`` of a [B, 2, 4, h1, w1] level-1
    output, read in place by its batch stride (for B = 1 that view is
    contiguous)."""
    b, h1, w1 = shape
    rng = np.random.RandomState(b * h1 + w1)
    ll = torch.as_tensor(rng.rand(b, 2 if strided else 1, 4, h1, w1).astype(np.float32) * 200,
                         device=cuda_device)
    x = ll[:, 0]
    assert x.is_contiguous() == (not strided or b == 1)
    got = tdm.dtcwt_qshift_masks(x, 5.0)
    torch.cuda.synchronize()
    want = tdm.dtcwt_qshift_masks_reference(x, 5.0)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())


# The q-shift synthesis tile (32 x 64 outputs of one frame and tree from a
# 23 x 39 input window; the full and lowpass-only modes share its template)
# and the delta's tile (64 x 128 pixels from 19 x 28 level-3 samples a tree)
# at their edges: planes smaller than the 7-sample halo (the circular index
# wraps more than once), odd h and w (2w % 4 != 0: no vector store), one tile
# exactly and a ragged last tile, grids that are not a multiple of the tile,
# B = 1 and B = 32, and a black frame's all-zero delta planes.
QSYN_SHAPES = [(2, 1, 1), (1, 1, 2), (2, 3, 5), (1, 17, 33), (1, 16, 32), (32, 16, 32),
               (1, 33, 65), (2, 45, 80)]
QSYN_PLANES = {"dtcwt_qshift_synthesis": 16, "dtcwt_qshift_synthesis_ll": 4}
DELTA_SHAPES = [(1, 1, 1), (2, 2, 3), (1, 17, 32), (1, 8, 16), (32, 9, 17), (2, 34, 64),
                (3, 17, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QSYN_SHAPES)
@pytest.mark.parametrize("name", list(QSYN_PLANES))
def test_qshift_synthesis_equals_plain_version_at_edge_shapes(cuda_device, name, shape):
    b, h, w = shape
    rng = np.random.RandomState(b * h + w)
    x = torch.as_tensor(rng.randn(b, QSYN_PLANES[name], h, w).astype(np.float32) * 50,
                        device=cuda_device)
    got = getattr(tds, name)(x)
    torch.cuda.synchronize()
    want = getattr(tds, name + "_reference")(x)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("shape", DELTA_SHAPES)
def test_delta_synthesis_equals_plain_version_at_edge_shapes(cuda_device, shape, zero):
    """``zero``: all-zero planes, a black frame's delta, which must be 0."""
    b, h3, w3 = shape
    rng = np.random.RandomState(b * h3 + w3)
    d = rng.randn(b, 12, h3, w3).astype(np.float32) * 20
    x = torch.as_tensor(np.zeros_like(d) if zero else d, device=cuda_device)
    got = tdd.dtcwt_delta_synthesis(x)
    torch.cuda.synchronize()
    want = tdd.dtcwt_delta_synthesis_reference(x)
    assert got.shape == want.shape == (b, 8 * h3, 8 * w3)
    assert torch.equal(got, want), float((got - want).abs().max())
    if zero:
        assert not got.any()


# The level-1 u8 lowpass tile (8 x 32 positions from a 20 x 68 pixel
# window; ll_y and ll_color share its template) and the flagship mark's
# strip (8 tile rows x 16 tiles) at their edges: a frame smaller than one
# tile and its halo (the circular index wraps more than once), grids that are
# not a multiple of the tile (h1 % 8 and w1 % 32 != 0),
# W % 4 == 2 (byte loads, odd W / 2: no paired stores), a batch whose base is
# not 4-byte aligned, B = 1 and B = 32; for the mark W % 16 != 0 (4-byte
# staging), W % 8 == 4 (a half tile passed through), tail rows below the
# block grid, and a contiguous planar batch (byte by byte through the strides).
LL_U8_SHAPES = [(1, 6, 10), (2, 38, 100), (32, 72, 136), (2, 236, 318), (1, 540, 960),
                (32, 24, 64)]
MARK_SHAPES = [(2, 40, 856), (1, 72, 132), (2, 48, 140), (1, 78, 128), (2, 1078, 256),
               (32, 64, 128), (1, 1080, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", LL_U8_SHAPES)
@pytest.mark.parametrize("name", ["dtcwt_level1_ll_y", "dtcwt_level1_ll_color"])
def test_level1_u8_lowpasses_equal_plain_versions_at_edge_shapes(cuda_device, name, shape,
                                                                 offset):
    """``offset``: the batch starts one byte into its buffer."""
    b, h, w = shape
    frames = natural_frames(np.random.RandomState(b * h + w), b, h, w)
    n = frames.size
    buf = torch.empty(n + int(offset), dtype=torch.uint8, device=cuda_device)
    x = buf[int(offset):].view(b, h, w, 3)
    x.copy_(torch.as_tensor(frames))
    assert x.is_contiguous() and x.data_ptr() % 4 == (1 if offset else 0)
    kernels.reset_launch_counts()
    got = getattr(tdl, name)(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == 1
    want = getattr(tdl, name + "_reference")(x)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("shape", MARK_SHAPES)
def test_fused_mark_equals_plain_version_at_edge_shapes(cuda_device, shape, planar):
    """``planar``: a contiguous [B, 3, H, W] batch instead of the interleaved
    view of [B, H, W, 3] frames; the output keeps the input's strides."""
    b, h, w = shape
    rng = np.random.RandomState(b * h + w)
    frames = torch.as_tensor(natural_frames(rng, b, h, w), device=cuda_device)
    planes = frames.permute(0, 3, 1, 2)
    if planar:
        planes = planes.contiguous()
    (nbh, nbw), _ = block_grid((h, w))
    wm2d = _wm(h, w, cuda_device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
    kernels.reset_launch_counts()
    got = tfe.fused_mark_planar(planes, wm2d, SCALE, 1)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_mark_planar"] == 1
    assert got.stride() == planes.stride()
    want = tfe.fused_mark_planar_reference(planes, wm2d, SCALE, 1)
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())
    assert torch.equal(got[:, :, 8 * nbh:], planes[:, :, 8 * nbh:])  # tail rows
    assert torch.equal(got[..., 8 * nbw:], planes[..., 8 * nbw:])  # the half tile
    assert not torch.equal(got, planes)


# The flagship kernels' integer bodies (int_path=True) at the mark strip's
# and the extract grid's edges: B = 1 and 33, W % 16 != 0 (4-byte staging;
# 1916 as a 1080p-class width), W % 8 == 4 (a half tile passed through),
# tail rows, 1080p, all-0 and all-255 frames (the epilogue's clamps), on the
# interleaved view and on a contiguous planar batch (bytes through the
# strides); each run twice.
INT_CASES = [(1, 72, 128, "natural"), (33, 40, 128, "natural"), (2, 48, 140, "natural"),
             (1, 72, 132, "natural"), (2, 1078, 256, "natural"), (2, 64, 1916, "natural"),
             (1, 1080, 1920, "natural"), (2, 72, 128, "black"), (2, 72, 128, "white")]


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("b,h,w,content", INT_CASES)
def test_int_path_bodies_equal_plain_versions_at_edge_shapes(cuda_device, b, h, w, content,
                                                             planar):
    frames = natural_frames(np.random.RandomState(b * h + w), b, h, w)
    if content != "natural":
        frames[:] = 0 if content == "black" else 255
    planes = torch.as_tensor(frames, device=cuda_device).permute(0, 3, 1, 2)
    if planar:
        planes = planes.contiguous()
    (nbh, nbw), _ = block_grid((h, w))
    wm2d = _wm(h, w, cuda_device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
    want = tfe.fused_mark_planar_reference(planes, wm2d, SCALE, 1, int_path=True)
    want_bits = tfe.fused_extract_planar_reference(want, SCALE, 1, int_path=True)
    for _ in range(2):
        kernels.reset_launch_counts()
        got = tfe.fused_mark_planar(planes, wm2d, SCALE, 1, int_path=True)
        bits = tfe.fused_extract_planar(got, SCALE, 1, int_path=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts[kernels.MARK_INT], counts[kernels.EXTRACT_INT]) == (1, 1), counts
        assert counts["fused_mark_planar"] == counts["fused_extract_planar"] == 0, counts
        assert got.stride() == planes.stride()
        assert torch.equal(got, want), int((got.int() - want.int()).abs().max())
        assert torch.equal(bits, want_bits)
    assert torch.equal(got[:, :, 8 * nbh:], planes[:, :, 8 * nbh:])  # tail rows
    assert torch.equal(got[..., 8 * nbw:], planes[..., 8 * nbw:])  # the half tile


@pytest.mark.cuda
@pytest.mark.parametrize("chan", [0, 2])
def test_int_path_bodies_on_the_other_channels(cuda_device, chan):
    """Y (every backward entry 1) and V (M_BWD[0, 2] == 0: B passes through)."""
    planes = torch.as_tensor(natural_frames(np.random.RandomState(chan), 2, 72, 128),
                             device=cuda_device).permute(0, 3, 1, 2)
    (nbh, nbw), _ = block_grid((72, 128))
    wm2d = _wm(72, 128, cuda_device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
    got = tfe.fused_mark_planar(planes, wm2d, SCALE, chan, int_path=True)
    bits = tfe.fused_extract_planar(got, SCALE, chan, int_path=True)
    torch.cuda.synchronize()
    assert torch.equal(got, tfe.fused_mark_planar_reference(planes, wm2d, SCALE, chan,
                                                            int_path=True))
    assert torch.equal(bits, tfe.fused_extract_planar_reference(got, SCALE, chan, int_path=True))


@pytest.mark.cuda
def test_int_path_codec_on_the_card_takes_the_int_bodies(cuda_device):
    frames = torch.as_tensor(natural_frames(np.random.RandomState(5), 3, 72, 128),
                             device=cuda_device)
    codec = DwtDctSvd(int_path=True)
    kernels.reset_launch_counts()
    marked = codec.mark_frames(frames, _wm(72, 128, cuda_device))
    bits = codec.extract_frames(marked)
    counts = kernels.launch_counts()
    assert (counts[kernels.MARK_INT], counts[kernels.EXTRACT_INT]) == (1, 1), counts
    assert not any(v for k, v in counts.items() if k not in (kernels.MARK_INT,
                                                             kernels.EXTRACT_INT)), counts
    assert (_payloads(bits) == PAYLOAD).all()
    plain = DwtDctSvd(backend="kernel", int_path=True).mark_frames(frames.cpu(),
                                                                   _wm(72, 128, "cpu"))
    assert torch.equal(marked.cpu(), plain)


# The f32 level-1 lowpass tile (8 x 32 positions from a 20 x 68 window, read
# through the input's strides) and the DCT-QIM mark's strip (4 tile rows x
# 16 tiles) at their edges: frames smaller than the window, h1 % 8 and w1 %
# 32 != 0, W % 4 == 2 (each column wrapped, odd w1: no paired stores), B = 1
# and B = 32; layouts: contiguous (16-byte cp.async), the Y view of an
# interleaved YUV batch (read in place, pixels 12 bytes apart) and a batch
# whose base is 4 bytes off 16-byte alignment (scalar loads).  For the mark:
# W % 16 != 0 (8-byte staging), nbw % 16 and nbh % 4 != 0, one tile, flat
# tiles (0/0 in the texture mask), the interleaved view (16- or 8-byte), the
# same view 4 bytes off alignment and a contiguous planar batch 1 byte off
# (both bytes through the strides), a contiguous planar batch (8-byte runs
# of each channel).
LEVEL1_LL_SHAPES = [(1, 2, 2), (1, 6, 10), (2, 18, 22), (2, 34, 98), (1, 38, 70), (32, 24, 40),
                    (2, 480, 854), (4, 720, 1280)]
DCT_MARK_SHAPES = [(1, 8, 8), (2, 40, 856), (1, 72, 136), (2, 24, 264), (32, 64, 128),
                   (2, 200, 136), (1, 1080, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "y_view", "offset"])
@pytest.mark.parametrize("shape", LEVEL1_LL_SHAPES)
def test_level1_f32_lowpass_equals_plain_version_at_edge_shapes(cuda_device, shape, layout):
    b, h, w = shape
    rng = np.random.RandomState(b * h + w)
    if layout == "y_view":
        frames = torch.as_tensor(natural_frames(rng, b, h, w), device=cuda_device)
        x = bgr_to_yuv(frames.to(torch.float32))[..., 0]
        assert x.stride() == (3 * h * w, 3 * w, 3)
    else:
        data = torch.as_tensor(rng.rand(b, h, w).astype(np.float32) * 255, device=cuda_device)
        off = int(layout == "offset")
        x = torch.empty(b * h * w + off, device=cuda_device)[off:].view(b, h, w)
        x.copy_(data)
        assert x.is_contiguous() and x.data_ptr() % 16 == (4 if off else 0)
    kernels.reset_launch_counts()
    got = tdl.dtcwt_level1_analysis_ll(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dtcwt_level1_analysis_ll"] == 1
    want = tdl.dtcwt_level1_analysis_ll_reference(x)
    assert got.shape == want.shape and torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, tdl.dtcwt_level1_analysis_ll(x.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "offset", "planar", "planar_offset", "flat"])
@pytest.mark.parametrize("shape", DCT_MARK_SHAPES)
def test_dct_qim_mark_equals_plain_version_at_edge_shapes(cuda_device, shape, layout):
    """``offset``: the interleaved view of a batch that starts 4 bytes into
    its buffer; ``planar_offset``: a contiguous planar batch 1 byte into its
    buffer; ``flat``: the interleaved view of frames with flat tiles."""
    b, h, w = shape
    rng = np.random.RandomState(b * h + w)
    frames = natural_frames(rng, b, h, w)
    if layout == "flat":
        frames[:, : h // 2] = 0
        frames[:, h // 2 :, : w // 2] = 128
    off = {"offset": 4, "planar_offset": 1}.get(layout, 0)
    buf = torch.empty(frames.size + 4, dtype=torch.uint8, device=cuda_device)
    if layout.startswith("planar"):
        planes = buf[off:][: frames.size].view(b, 3, h, w)
        planes.copy_(torch.as_tensor(frames.transpose(0, 3, 1, 2)))
        assert planes.is_contiguous() and planes.data_ptr() % 8 == off
    else:
        x = buf[off:][: frames.size].view(b, h, w, 3)
        x.copy_(torch.as_tensor(frames))
        planes = x.permute(0, 3, 1, 2)
    wm2d = torch.as_tensor(rng.randint(0, 2, (h // 8, w // 8)).astype(np.float32),
                           device=cuda_device)
    means = tdq.y_dc_mean_reference(planes)
    kernels.reset_launch_counts()
    got = tdq.fused_dct_qim_mark(planes, wm2d, 20.0, means)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_dct_qim_mark"] == 1
    assert got.stride() == planes.stride()
    want = tdq.fused_dct_qim_mark_reference(planes, wm2d, 20.0, means)
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())
    assert not torch.equal(got, planes)


# The Y mean's and the extract's layouts and edges: W = 856 (8-byte rows of
# the interleaved view; 107 tiles a row), a contiguous planar batch and the
# interleaved view 4 bytes into its buffer (both bytes through the strides),
# flat tiles, a black and an all-255 frame, B = 1 and B = 33.
DCT_MEAN_CASES = [(2, 40, 856, "interleaved"), (2, 64, 128, "planar"), (2, 64, 128, "offset"),
                  (2, 64, 128, "flat"), (2, 64, 128, "black"), (2, 64, 128, "white"),
                  (1, 72, 136, "interleaved"), (33, 16, 16, "interleaved"),
                  (2, 1080, 1920, "interleaved")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,layout", DCT_MEAN_CASES)
def test_y_mean_and_extract_equal_plain_versions_at_edge_shapes(cuda_device, b, h, w, layout):
    rng = np.random.RandomState(b * h + w)
    frames = natural_frames(rng, b, h, w)
    if layout == "flat":
        frames[:, : h // 2] = 0
        frames[:, h // 2 :, : w // 2] = 128
    elif layout in ("black", "white"):
        frames[:] = 0 if layout == "black" else 255
    buf = torch.empty(frames.size + 4, dtype=torch.uint8, device=cuda_device)
    off = 4 if layout == "offset" else 0
    if layout == "planar":
        planes = buf[: frames.size].view(b, 3, h, w)
        planes.copy_(torch.as_tensor(frames.transpose(0, 3, 1, 2)))
    else:
        x = buf[off:][: frames.size].view(b, h, w, 3)
        x.copy_(torch.as_tensor(frames))
        planes = x.permute(0, 3, 1, 2)
    kernels.reset_launch_counts()
    means = tdq.y_dc_mean(planes)
    torch.cuda.synchronize()
    want_means = tdq.y_dc_mean_reference(planes)
    assert torch.equal(means, want_means), (means, want_means)
    assert torch.equal(tdq.y_dc_mean(planes), means)  # atomics in any order, the same sum
    bits = tdq.fused_dct_qim_extract(planes, 20.0)  # the frame's mean taken in the same read
    torch.cuda.synchronize()
    assert torch.equal(bits, tdq.fused_dct_qim_extract_reference(planes, 20.0))
    assert torch.equal(tdq.fused_dct_qim_extract(planes, 20.0), bits)  # partials in any order
    counts = kernels.launch_counts()
    assert (counts["y_dc_mean"], counts["fused_dct_qim_extract"],
            counts[kernels.EXTRACT_DECIDE]) == (2, 2, 2), counts


@pytest.mark.cuda
def test_two_mark_calls_with_one_plane_compute_its_spectrum_once(cuda_device):
    rng = np.random.RandomState(8)
    codec = DtcwtKey()
    wm = torch.as_tensor(CorrShuffler(0).generate_wm(None, codec.wm_capacity((72, 128, 3))),
                         device=cuda_device)
    clear_wm_cache()
    kernels.reset_launch_counts()
    first = codec.mark_frames(torch.as_tensor(natural_frames(rng, 2, 72, 128), device=cuda_device),
                              wm)
    second = codec.mark_frames(torch.as_tensor(natural_frames(rng, 2, 72, 128),
                                               device=cuda_device), wm)
    counts = kernels.launch_counts()
    assert counts["dtcwt_level1_analysis"] == 1 and counts["dtcwt_level1_ll_y"] == 2, counts
    assert first.shape == second.shape == (2, 72, 128, 3)


# -- submit/collect and the HLS workflow on the card ------------------------

def _markers(device, h, w, batch_size=4):
    from vfp_tpu_torch.pipeline import FrameExtractor, MultiMarker

    wms = [Shuffler(key=0).generate_wm(p, (1, h * w // 64)) for p in (PAYLOAD, 1 - PAYLOAD)]
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    return (MultiMarker(DwtDctSvd(), wms, batch_size, device=device),
            FrameExtractor(DwtDctSvd(), deg, batch_size, device=device))


@pytest.mark.cuda
def test_staging_is_reused_and_held_outputs_stay_valid(cuda_device):
    """Eight batches of two shapes submitted before any collect: one staging
    buffer per shape, refilled in turn, and every output equal to a fresh
    call made afterwards (a destination reused too early would differ)."""
    from vfp_tpu_torch.pipeline.transfer import STAGING

    rng = np.random.RandomState(21)
    shapes = [(64, 96), (72, 128)]
    mms = {s: _markers(cuda_device, *s) for s in shapes}
    batches = [(shapes[i % 2], natural_frames(rng, 4 - (i // 2) % 2, *shapes[i % 2]))
               for i in range(8)]
    before = set(STAGING._buffers)
    handles = [mms[s][0].submit(b) for s, b in batches]
    assert all(h.done is not None for h in handles)  # each waits on its own event
    key = {s: (cuda_device, (4, *s, 3), torch.uint8) for s in shapes}  # (device, shape, dtype)
    staged = {s: STAGING._buffers[key[s]] for s in shapes}
    outs = [mms[s][0].collect(h) for (s, _), h in zip(batches, handles)]
    for (s, b), o in zip(batches, outs):
        assert o.shape == (2, len(b), *s, 3)
        np.testing.assert_array_equal(o, mms[s][0].mark_all(b))
        np.testing.assert_array_equal(mms[s][1].extract(o[0]), np.tile(PAYLOAD, (len(b), 1)))
        np.testing.assert_array_equal(mms[s][1].collect(mms[s][1].submit(o[1])),
                                      np.tile(1 - PAYLOAD, (len(b), 1)))
    assert set(STAGING._buffers) - before <= set(key.values())
    assert all(STAGING._buffers[key[s]] is staged[s] for s in shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 5])
def test_staging_upload_of_a_1080p_batch_equals_a_plain_copy(cuda_device, k):
    """A 1080p B=16 upload (``k`` frames, padded with the last) equals the
    plain copy of the padded batch, whether or not the host copy fans out,
    also when the staging buffer is refilled at once; it fans out over the
    rule's number of threads exactly when that is 2 or more."""
    from vfp_tpu_torch.pipeline.transfer import STAGING
    from vfp_tpu_torch.utils.profiling import record_spans

    frames = np.random.default_rng(k).integers(0, 256, (k, 1080, 1920, 3), dtype=np.uint8)
    padded = np.concatenate([frames, np.repeat(frames[-1:], 16 - k, axis=0)])
    want = torch.from_numpy(padded).cuda()
    with record_spans() as spans:
        xs = [STAGING.upload(frames, 16, cuda_device) for _ in range(2)]
    assert all(torch.equal(x, want) for x in xs)
    n = STAGING._fanout.threads(padded.nbytes)
    fans = [s.items for s in spans if s.name == "transfer.stage_fanout"]
    assert fans == ([n, n] if n >= 2 else [])


@pytest.mark.cuda
def test_two_threads_uploading_back_to_back_get_their_own_bytes(cuda_device):
    """Two threads upload 1080p batches of one shape and different content,
    four each, with no wait between the calls and nothing synchronised
    until the end: each result holds its own thread's bytes, so the shared
    staging buffer was never refilled before its H2D had read it."""
    import threading

    from vfp_tpu_torch.pipeline.transfer import STAGING

    rng = np.random.default_rng(31)
    frames = [rng.integers(0, 256, (16, 1080, 1920, 3), dtype=np.uint8) for _ in range(2)]
    got, errors = {0: [], 1: []}, []
    meet = threading.Barrier(2, timeout=30)

    def run(i):
        try:
            meet.wait()
            for _ in range(4):
                got[i].append(STAGING.upload(frames[i], 16, cuda_device))
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    torch.cuda.synchronize()
    for i in (0, 1):
        want = torch.from_numpy(frames[i]).cuda()
        assert len(got[i]) == 4 and all(torch.equal(x, want) for x in got[i])


@pytest.mark.cuda
def test_embedder_with_two_calls_in_flight_marks_as_one_call_at_a_time(cuda_device):
    """``Embedder`` over a marker that has only ``mark`` and ``batch_size``
    (the benchmark's driver hands it one): 1080p DT-CWT key batches in flight
    two at a time give the bytes of the calls made one at a time, in order."""
    from vfp_tpu_torch.io import ArrayReader, ArrayWriter
    from vfp_tpu_torch.pipeline import Embedder, FrameMarker

    class MarkOnly:
        def __init__(self, marker):
            self.marker, self.batch_size = marker, marker.batch_size

        def mark(self, frames):
            return self.marker.mark(frames)

    codec = DtcwtKey()
    wm = CorrShuffler(key=0).generate_wm(None, codec.wm_capacity((1080, 1920, 3)))
    marker = FrameMarker(codec, wm, 16, device=cuda_device)
    frames = natural_frames(np.random.RandomState(45), 40, 1080, 1920)  # 16, 16, 8
    writer = ArrayWriter()
    stats = Embedder(ArrayReader(frames), MarkOnly(marker), writer).start()
    assert stats.frames == 40
    serial = np.concatenate([marker.mark(frames[i:i + 16]) for i in range(0, 40, 16)])
    np.testing.assert_array_equal(writer.frames, serial)


@pytest.mark.cuda
def test_collect_from_another_thread(cuda_device):
    import threading

    rng = np.random.RandomState(22)
    mm, fx = _markers(cuda_device, 64, 96)
    frames = [natural_frames(rng, 3, 64, 96) for _ in range(4)]
    handles = [mm.submit(f) for f in frames]
    got = {}

    def collect():
        got["outs"] = [mm.collect(h) for h in handles]
        got["bits"] = fx.collect(fx.submit(got["outs"][0][0]))

    t = threading.Thread(target=collect)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(got["outs"]) == 4
    for f, o in zip(frames, got["outs"]):
        np.testing.assert_array_equal(o, mm.mark_all(f))
    np.testing.assert_array_equal(got["bits"], np.tile(PAYLOAD, (3, 1)))


@pytest.mark.cuda
def test_mark_segments_then_verify_on_the_card(cuda_device, tmp_path):
    from vfp_tpu_torch import fingerprint
    from vfp_tpu_torch.fingerprint.marker import verify_segments
    from vfp_tpu_torch.io import RawVideoWriter

    src = tmp_path / "src.rawv"
    with RawVideoWriter(src, 96, 64, fps=6) as w:
        w.write_batch(natural_frames(np.random.RandomState(23), 18, 64, 96))
    segs = fingerprint.segment_video(src, tmp_path / "segments", 2.0)
    kernels.reset_launch_counts()
    stats: dict = {}
    marked, payloads, copies = fingerprint.mark_segments(
        segs, tmp_path / "marked_segments", copies=3, batch_size=8, stats=stats,
        device=cuda_device)
    verified = verify_segments(marked, batch_size=4, device=cuda_device)
    counts = kernels.launch_counts()
    assert all(ok and f == 1.0 for _, f, ok in verified), verified
    # marks: 2 + 1 batches x 3 variants; verify: 54 frames packed in 4s
    assert counts["fused_mark_planar"] == 9 and counts["fused_extract_planar"] == 14, counts
    assert stats["stage_seconds"]["device_full"] >= 0.0
    fingerprint.write_manifests(tmp_path, payloads, copies)
    leaked, _ = fingerprint.generate_leak(tmp_path / "segment_copies.json", pattern="20")
    result = fingerprint.trace_leak(leaked, tmp_path / "det", tmp_path / "segment_payloads.json",
                                    device=cuda_device)
    assert result.fingerprint == "20" and result.success_rate == 1.0


@pytest.mark.cuda
def test_mjpeg_avi_round_trip_to_the_card(cuda_device, tmp_path):
    """An MJPEG .avi written by the port, read back by its reader (the native
    JPEG codec), uploads to the card and comes back unchanged, and a segment
    of it verifies on the card as its decoded frames do on the CPU."""
    from vfp_tpu_torch.fingerprint.marker import _read_all, verify_segment
    from vfp_tpu_torch.io import MjpegAviReader, open_writer
    from vfp_tpu_torch.native import decode_jpeg, encode_jpeg
    from vfp_tpu_torch.pipeline import FrameMarker
    from vfp_tpu_torch.pipeline.transfer import download, upload_batch
    from vfp_tpu_torch.workflows.durability import payload_for_segment_8bit

    frames = natural_frames(np.random.RandomState(31), 12, 64, 96)
    codec = DwtDctSvd()
    payload = payload_for_segment_8bit(5)
    wm = Shuffler(key=0).generate_wm(payload, codec.wm_capacity((64, 96, 3)))
    marked = FrameMarker(codec, wm, 8, device=cuda_device).mark(frames)
    path = tmp_path / "seg.avi"
    with open_writer(path, 96, 64, 6.0, 95) as w:
        w.write_batch(marked)
    r = MjpegAviReader(path)
    got = np.concatenate([r.read_batch(5), r.read_batch(5), r.read_batch(5)])
    r.close()
    want = np.stack([decode_jpeg(encode_jpeg(f, 95)) for f in marked])
    assert np.array_equal(got, want)
    x = upload_batch(got[:8], 8, cuda_device)
    assert x.device.type == cuda_device.type
    assert np.array_equal(download([x], 8).wait()[0], got[:8])
    frames_back, fps = _read_all(path)
    assert np.array_equal(frames_back, want) and fps == 6.0
    pattern, freq, ok = verify_segment(path, payload, codec=codec, batch_size=8,
                                       device=cuda_device)
    cpu = verify_segment(path, payload, codec=codec, batch_size=8, device="cpu")
    assert np.array_equal(pattern, cpu[0]) and freq == cpu[1] and ok == cpu[2]


@pytest.mark.cuda
def test_corr_batch_fn_on_the_card_matches_its_cpu_result(cuda_device):
    """The durability experiment's correlation table on the card (DT-CWT detect
    kernels, float32 einsum with TF32 off) against the CPU's kernel path,
    within 1e-4; the table's argmax (the identified key) equal."""
    from vfp_tpu_torch.workflows.durability import _corr_batch_fn

    rng = np.random.RandomState(37)
    codec = DtcwtKey()
    h, w = 128, 192
    cap = tuple(codec.wm_capacity((h, w, 3)))
    refs = np.stack([DeCorrShuffler(key=k)._reference(cap) for k in range(5)]).astype(np.float32)
    wm = torch.as_tensor(CorrShuffler(key=2).generate_wm(None, cap), device=cuda_device)
    frames = torch.as_tensor(natural_frames(rng, 8, h, w), device=cuda_device)
    kernels.reset_launch_counts()
    clear_wm_cache()
    marked = codec.mark_frames(frames, wm)
    got = _corr_batch_fn(codec, refs.shape, device=cuda_device)(
        marked, torch.as_tensor(refs, device=cuda_device)).cpu().numpy()
    counts = kernels.launch_counts()
    assert all(counts[k] == 1 for k in DETECT_KERNELS), counts
    want = _corr_batch_fn(codec, refs.shape, device="cpu")(marked.cpu(),
                                                           torch.as_tensor(refs)).numpy()
    assert got.shape == (8, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(axis=1) == 2).all() and (want.argmax(axis=1) == 2).all()


# -- the LL-domain transport (pipeline/lowlink.py) on the card ------------------------

def _ll_wms(h, w, n):
    from vfp_tpu_torch.fingerprint import payload_for_segment

    return [np.asarray(Shuffler(key=0).generate_wm(payload_for_segment(1, c), (1, h * w // 64)),
                       np.float32).reshape(-1) for c in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["u8", "f16"])
@pytest.mark.parametrize("n_variants", [1, 3])
def test_lowlink_marker_on_the_card_matches_its_cpu_result(cuda_device, monkeypatch, wire,
                                                           n_variants):
    """The transport on the card: one qim_triplet_soa launch a batch, no
    fused kernel; the marked frames against the same marker on the CPU
    (the plain triplet) within +-1 on >= 99.9% of pixels, every variant's
    payload recovered by the card's extractor (one qim_decode_soa a batch)."""
    from vfp_tpu_torch.fingerprint import payload_for_segment
    from vfp_tpu_torch.pipeline import FrameExtractor, MultiMarker

    monkeypatch.setenv("VFP_LOWLINK", "1")
    monkeypatch.setenv("VFP_LL_WIRE", wire)
    rng = np.random.RandomState(41)
    h, w = 240, 318
    frames = natural_frames(rng, 6, h, w)
    wms = _ll_wms(h, w, n_variants)
    kernels.reset_launch_counts()
    mm = MultiMarker(DwtDctSvd(), wms, 4, device=cuda_device)
    assert mm._ll is not None and mm.wms is None
    got = np.concatenate([mm.collect(hd) for hd in (mm.submit(frames[:4]), mm.submit(frames[4:]))],
                         axis=1)
    counts = kernels.launch_counts()
    want = MultiMarker(DwtDctSvd(), wms, 4, device="cpu").mark_all(frames)
    assert counts["qim_triplet_soa"] == 2, counts
    assert not any(v for k, v in counts.items() if k != "qim_triplet_soa"), counts
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
    deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
    fx = FrameExtractor(DwtDctSvd(), deg, 4, device=cuda_device)
    kernels.reset_launch_counts()
    for v in range(n_variants):
        np.testing.assert_array_equal(fx.extract(got[v, :4]),
                                      np.tile(payload_for_segment(1, v), (4, 1)))
    counts = kernels.launch_counts()
    assert counts["qim_decode_soa"] == n_variants and counts["fused_extract_planar"] == 0


@pytest.mark.cuda
def test_lowlink_packer_on_the_card_equals_unpacked(cuda_device, monkeypatch):
    """Three 6-frame segments packed into calls of at most 16 frames on the
    card: each segment's variants equal its unpacked two-plane marker's."""
    from vfp_tpu_torch.pipeline.lowlink import LowLinkMarker, PackedTwoPlane

    monkeypatch.setenv("VFP_LOWLINK", "1")
    rng = np.random.RandomState(42)
    segs = [natural_frames(rng, 6, 128, 192) for _ in range(3)]
    wms = _ll_wms(128, 192, 3)
    codec = DwtDctSvd()
    packer = PackedTwoPlane(codec, pack=16, device=cuda_device)
    mms = [LowLinkMarker(codec, wms, 16, packer=packer, device=cuda_device) for _ in segs]
    kernels.reset_launch_counts()
    handles = [m.submit(f) for m, f in zip(mms, segs)]
    packer.flush()
    outs = [m.collect(hd) for m, hd in zip(mms, handles)]
    assert packer.call_frames == [16, 2]
    assert kernels.launch_counts()["qim_triplet_soa"] == 2
    for f, o in zip(segs, outs):
        np.testing.assert_array_equal(o, LowLinkMarker(codec, wms, 16,
                                                       device=cuda_device).mark_all(f))


@pytest.mark.cuda
def test_lowlink_host_wire_leaves_the_card_alone(cuda_device, monkeypatch):
    """VFP_LL_WIRE=host with a CUDA device: mark and detect on the host, no
    launch and no device memory allocated."""
    from vfp_tpu_torch.pipeline import FrameExtractor, FrameMarker

    monkeypatch.setenv("VFP_LL_WIRE", "host")
    monkeypatch.delenv("VFP_LOWLINK", raising=False)
    frames = natural_frames(np.random.RandomState(43), 4, 128, 192)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    marked = FrameMarker(DwtDctSvd(), _wm(128, 192, "cpu").numpy(), 4,
                         device=cuda_device).mark(frames)
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    payloads = FrameExtractor(DwtDctSvd(), deg, 4, device=cuda_device).extract(marked)
    assert not any(kernels.launch_counts().values())
    assert torch.cuda.memory_allocated() == before
    np.testing.assert_array_equal(payloads, np.tile(PAYLOAD, (4, 1)))


# -- the span recorder on the card (utils/profiling.py) -------------------------------

EVENT_WAITS = ("sync.stage_wait", "sync.result_wait")  # explicit event waits
# the sync.* spans of one warm 1080p batch call, in order
BATCH_SYNCS = {
    "dtcwtKey-mark": ["sync.stage_wait", "sync.result_wait"],
    "dtcwtKey-submit-collect": ["sync.stage_wait", "sync.result_wait"],
    "dtcwtKey-extract": ["sync.stage_wait", "sync.corr_reference", "sync.result_wait"],
    "dwtDctSvd-mark": ["sync.stage_wait", "sync.result_wait"],
    "dwtDctSvd-extract": ["sync.stage_wait", "sync.despread_counts", "sync.unshuffle_index",
                          "sync.result_wait"],
}


def _warm_batch_call(path, device, h=1080, w=1920, b=16):
    """A batch call of ``path`` at 1080p, run twice so that its caches and
    kernels are warm."""
    import functools

    from vfp_tpu_torch.pipeline import FrameExtractor, FrameMarker, MultiMarker

    name, call = path.split("-", 1)
    if name == "dtcwtKey":
        codec = DtcwtKey()
        wms = [CorrShuffler(key=k).generate_wm(None, codec.wm_capacity((h, w, 3)))
               for k in (0, 1)]
        deg = DeCorrShuffler(key=0)
    else:
        codec = DwtDctSvd()
        wms = [_wm(h, w, "cpu").numpy()]
        deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    frames = natural_frames(np.random.RandomState(44), b, h, w)
    if call == "mark":
        fn = functools.partial(FrameMarker(codec, wms[0], b, device=device).mark, frames)
    elif call == "submit-collect":  # mark_all: collect(submit(frames))
        fn = functools.partial(MultiMarker(codec, wms, b, device=device).mark_all, frames)
    else:
        marked = FrameMarker(codec, wms[0], b, device=device).mark(frames)
        fn = functools.partial(FrameExtractor(codec, deg, b, device=device).extract, marked)
    fn()
    fn()
    torch.cuda.synchronize()
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(BATCH_SYNCS))
def test_sync_debug_warnings_are_the_implicit_sync_spans(cuda_device, path):
    """One warm 1080p batch call: every synchronizing call that torch's
    sync debug mode reports falls in one implicit ``sync.*`` span, and each
    of those holds one, so no implicit host sync of the batch path escapes
    the count; with the two event waits they are every ``sync.*`` span."""
    import time
    import warnings

    from vfp_tpu_torch.utils.profiling import record_spans

    fn = _warm_batch_call(path, cuda_device)
    seen = []

    def show(message, category, *args, **kwargs):
        if "called a synchronizing" in str(message):  # not the mode's own notice
            seen.append(time.perf_counter_ns())

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with record_spans() as spans:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sorted((s for s in spans if s.name.startswith("sync.")), key=lambda s: s.t0)
    assert [s.name for s in syncs] == BATCH_SYNCS[path]
    implicit = [s for s in syncs if s.name not in EVENT_WAITS]
    assert len(seen) == len(implicit)
    for s in implicit:
        assert sum(s.t0 <= t <= s.t1 for t in seen) == 1, s.name


@pytest.mark.cuda
def test_the_codec_kernels_lie_inside_their_spans_on_the_traced_clock(cuda_device):
    """The benchmark's tracer maps device events onto ``perf_counter_ns``;
    the batch's mask and delta kernels start after its ``codec.mark`` span
    opens and end before its ``marker.mark`` span closes, to within 1 ms."""
    import importlib.util
    import sys
    from pathlib import Path

    from vfp_tpu_torch.utils.profiling import record_spans

    path = Path(__file__).resolve().parents[1] / "portbench" / "harness" / "trace.py"
    spec = importlib.util.spec_from_file_location("portbench_harness_trace", path)
    trace = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    fn = _warm_batch_call("dtcwtKey-mark", cuda_device)
    tracer = trace.Tracer()
    tracer.start()
    with record_spans() as spans:
        fn()
    tracer.stop()
    (mark,) = [s for s in spans if s.name == "marker.mark"]
    (codec,) = [s for s in spans if s.name == "codec.mark"]
    kernels_ = [(a, b) for n, a, b in tracer.events() if "masks_kernel" in n or "delta_kernel" in n]
    assert len(kernels_) == 2
    ms = 1_000_000
    for a, b in kernels_:
        assert codec.t0 - ms <= a < b <= mark.t1 + ms
