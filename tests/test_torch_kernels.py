"""vfp_tpu_torch.kernels: the plain versions against the Pallas kernels, the
wrappers' dispatch and checks, and the C interface the build binds.

The Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Stated tolerances (the port's plain versions vs the Pallas kernels):
s0 rtol 2e-5; the rank-1 action u vᵀ atol 2e-5; decoded bits identical on
>= 99.9% of blocks; marked u8 identical on >= 99.5% of pixels with the
payload recovered (a borderline s0 may take the other, parity-equivalent QIM
bin).  The CUDA kernels themselves run only on a GPU: see
tests/test_torch_cuda.py and chip_smoke.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.kernels import fused_embed as jfe, qim as jqim
from vfp_tpu.wm.dwt_dct_svd import DwtDctSvd as JaxDwtDctSvd, block_grid
from vfp_tpu_torch import kernels
from vfp_tpu_torch.kernels import _build, fused_embed as tfe, qim as tqim

from torch_parity import PAYLOAD, despread, natural_frames, spread_wm

torch.set_num_threads(1)
SCALE = 15.0
FUSED_SHAPES = [(72, 128), (40, 856), (78, 128)]


def _soa(rng, n):
    return (rng.rand(2, 16, n) * 300).astype(np.float32)


def _fused_inputs(rng, h, w):
    frames = natural_frames(rng, 2, h, w)
    (nbh, nbw), cap = block_grid((h, w), 4)
    wm2d = spread_wm(h, w)[: nbh * nbw].reshape(nbh, nbw)
    return frames.transpose(0, 3, 1, 2).copy(), wm2d, (nbh, nbw), cap


# -- plain versions vs the Pallas kernels ---------------------------------------

@pytest.mark.parametrize("n", [700, 33])
def test_triplet_reference_matches_pallas(rng, n):
    m = _soa(rng, n)
    ws0, wu, wv = (np.asarray(a) for a in jqim.qim_triplet_soa(jnp.asarray(m), interpret=True))
    s0, u, v = (a.numpy() for a in tqim.qim_triplet_soa_reference(torch.from_numpy(m)))
    np.testing.assert_allclose(s0, ws0, rtol=2e-5)
    np.testing.assert_allclose(u[:, :, None] * v[:, None], wu[:, :, None] * wv[:, None], atol=2e-5)


@pytest.mark.parametrize("n", [700, 33])
def test_decode_reference_matches_pallas(rng, n):
    m = _soa(rng, n)
    want = np.asarray(jqim.qim_decode_soa(jnp.asarray(m), SCALE, interpret=True))
    got = tqim.qim_decode_soa_reference(torch.from_numpy(m), SCALE).numpy()
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("n", [700, 33])
def test_embed_reference_matches_pallas(rng, n):
    m = _soa(rng, n)
    wm = rng.randint(0, 2, n).astype(np.float32)
    want = np.asarray(jqim.qim_embed_soa(jnp.asarray(m), jnp.asarray(wm), SCALE, interpret=True))
    got = tqim.qim_embed_soa_reference(torch.from_numpy(m), torch.from_numpy(wm), SCALE).numpy()
    close = (np.abs(got - want) <= 2e-3).all(axis=1)  # per block
    assert close.mean() >= 0.999
    bits = tqim.qim_decode_soa_reference(torch.from_numpy(got), SCALE).numpy()
    assert (bits == wm).mean() >= 0.999


@pytest.mark.parametrize("h,w", FUSED_SHAPES)
def test_fused_mark_reference_matches_pallas(rng, h, w):
    planes, wm2d, (nbh, nbw), cap = _fused_inputs(rng, h, w)
    want = np.asarray(jfe.fused_mark_planar(jnp.asarray(planes), jnp.asarray(wm2d), SCALE, 1,
                                            interpret=True))
    got = tfe.fused_mark_planar_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                          SCALE, 1).numpy()
    assert (got == want).mean() >= 0.995
    bits = tfe.fused_extract_planar_reference(torch.from_numpy(got), SCALE, 1).numpy()
    flat = np.zeros((2, cap), np.float32)
    flat[:, : nbh * nbw] = bits.reshape(2, -1)
    for p in despread(flat):
        np.testing.assert_array_equal(p, PAYLOAD)


@pytest.mark.parametrize("h,w", FUSED_SHAPES)
def test_fused_extract_reference_matches_pallas(rng, h, w):
    planes, wm2d, (nbh, nbw), _ = _fused_inputs(rng, h, w)
    marked = np.asarray(jfe.fused_mark_planar(jnp.asarray(planes), jnp.asarray(wm2d), SCALE, 1,
                                              interpret=True))
    want = np.asarray(jfe.fused_extract_planar(jnp.asarray(marked), SCALE, 1, interpret=True))
    got = tfe.fused_extract_planar_reference(torch.from_numpy(marked.copy()), SCALE, 1).numpy()
    assert got.shape == (2, nbh, nbw)
    assert (got == want).mean() >= 0.999


def test_fused_mark_tail_rows_pass_through(rng):
    """h4 % 8 != 0: rows past the block grid are the input, as the XLA path
    leaves them (the delta there is exactly zero, so no tolerance applies)."""
    planes, wm2d, (nbh, nbw), _ = _fused_inputs(rng, 78, 128)
    assert 8 * nbh < 78 // 4 * 4
    got = tfe.fused_mark_planar_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                          SCALE, 1).numpy().transpose(0, 2, 3, 1)
    frames = planes.transpose(0, 2, 3, 1)
    want = np.asarray(JaxDwtDctSvd(backend="xla").mark_frames(
        jnp.asarray(frames), jnp.asarray(spread_wm(78, 128))))
    np.testing.assert_array_equal(got[:, 8 * nbh:], want[:, 8 * nbh:])
    np.testing.assert_array_equal(got[:, 8 * nbh:], frames[:, 8 * nbh:])


# -- wrappers -------------------------------------------------------------------

def _wrapper_calls(rng):
    m = torch.from_numpy(_soa(rng, 40))
    wm = torch.from_numpy(rng.randint(0, 2, 40).astype(np.float32))
    planes, wm2d, _, _ = _fused_inputs(rng, 40, 64)
    planes, wm2d = torch.from_numpy(planes), torch.from_numpy(wm2d)
    return {
        "qim_triplet_soa": ((m,), tqim.qim_triplet_soa_reference),
        "qim_decode_soa": ((m, SCALE), tqim.qim_decode_soa_reference),
        "qim_embed_soa": ((m, wm, SCALE), tqim.qim_embed_soa_reference),
        "fused_mark_planar": ((planes, wm2d, SCALE, 1), tfe.fused_mark_planar_reference),
        "fused_extract_planar": ((planes, SCALE, 1), tfe.fused_extract_planar_reference),
    }


@pytest.mark.parametrize("name", [k.__name__ for k in kernels.KERNELS])
def test_wrapper_takes_plain_version_on_cpu(rng, name):
    args, reference = _wrapper_calls(rng)[name]
    kernels.reset_launch_counts()
    got = getattr(kernels, name)(*args)
    want = reference(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert kernels.launch_counts()[name] == 0  # no kernel launched on the CPU
    assert _build._lib is None  # and nothing was built


@pytest.mark.parametrize("bad", ["dtype", "shape", "width"])
def test_wrappers_reject_malformed_input(rng, bad):
    m = torch.from_numpy(_soa(rng, 8))
    planes = torch.zeros((1, 3, 16, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        if bad == "dtype":
            tqim.qim_decode_soa(m.double(), SCALE)
        elif bad == "shape":
            tqim.qim_triplet_soa(m[:, :9])
        else:
            tfe.fused_extract_planar(planes[..., :30], SCALE, 1)
    with pytest.raises(ValueError):
        tfe.fused_mark_planar(planes, torch.zeros(3, 3), SCALE, 1)  # bits of the wrong grid


def test_fused_mark_returns_a_new_tensor(rng):
    """No aliasing: the input survives and repeated calls agree."""
    planes, wm2d, _, _ = _fused_inputs(rng, 72, 128)
    x = torch.from_numpy(planes.copy())
    a = tfe.fused_mark_planar(x, torch.from_numpy(wm2d), SCALE, 1)
    assert np.array_equal(x.numpy(), planes)
    assert torch.equal(a, tfe.fused_mark_planar(x, torch.from_numpy(wm2d), SCALE, 1))
    assert not torch.equal(a, x)


# -- the build and the C interface ---------------------------------------------------

def test_build_flags_keep_ieee_float():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "vfp_tpu_torch")
    assert {p.name for p in _build.sources()} == {"qim.cu", "fused_embed.cu", "triplet.cuh"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_launcher(name):
    """argtypes must list exactly the C launcher's parameters (stream last):
    a mismatch would pass garbage to the card without a compile error."""
    src = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert match, name
    params = [p.strip() for p in match.group(1).split(",")]
    assert len(params) == len(_build.SIGNATURES[name])
    assert params[-1] == "void* stream"
    scalars = {"int": _build.ctypes.c_int, "float": _build.ctypes.c_float}
    for p, t in zip(params, _build.SIGNATURES[name]):
        ctype = p.rsplit(" ", 1)[0]
        want = _build.ctypes.c_void_p if "*" in ctype else scalars[ctype]
        assert t is want, (name, p)
