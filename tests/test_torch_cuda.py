"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Every test needs a CUDA GPU and skips without one.  This file imports no
jax (the GPU machine has none), so it runs there without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: float outputs rtol/atol 2e-5 (the kernels and their plain
versions share one op order, IEEE division and no FMA); u8 marks identical on
>= 99.5% of pixels and bits on >= 99.9% (a borderline s0 may take the other,
parity-equivalent QIM bin).
"""

import numpy as np
import pytest
import torch

from vfp_tpu_torch import kernels
from vfp_tpu_torch.kernels import fused_embed as tfe, qim as tqim
from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd, Shuffler, block_grid

from torch_parity import PAYLOAD, cuda_device, natural_frames  # noqa: F401

SCALE = 15.0


def _wm(h, w, device):
    wm = Shuffler(key=0).generate_wm(PAYLOAD, (1, h * w // 64))
    return torch.as_tensor(np.asarray(wm, np.float32).reshape(-1), device=device)


def _payloads(bits):
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    return deg.degenerate_batch(bits).cpu().numpy()


def _inputs(name, device, rng, h, w):
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
    want = getattr(tfe if name.startswith("fused") else tqim, name + "_reference")(*args)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype == torch.uint8:
            assert (g == r).float().mean() >= 0.995
        elif name.endswith("extract_planar") or name == "qim_decode_soa":
            assert (g == r).float().mean() >= 0.999
        else:
            torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5)


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
