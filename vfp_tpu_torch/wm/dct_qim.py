"""Perceptually masked DCT-QIM watermark codec on frame batches (port of
``vfp_tpu/wm/dct_qim.py``).

One bit per 8x8 block of the U channel: QIM on DCT coefficient [2][1] with
step = alpha * luminance_mask * texture_mask, both masks computed per block
from the Y channel (a DC-based luminance model; an energy-classification
texture model with edge detection).  Blocks live in SoA layout [B, 64, N]
and the 8x8 DCT is one 64x64 Kronecker product, as in the JAX package's
``"xla"`` path.

Division quirks kept on purpose: the reference computes l/e and (l+e)/h
without guarding e == 0 or h == 0, so inf and NaN comparisons decide the
branch; IEEE division reproduces that.  Divisions by constants divide by a
tensor, because PyTorch's CUDA division by a Python scalar is a multiply by
its reciprocal.

``backend``: ``"kernel"`` takes the fused CUDA kernels of
``kernels/fused_dct_qim.py`` (their plain versions for CPU tensors),
``"torch"`` the tensor path below that mirrors the JAX ``"xla"`` path,
``"auto"`` the kernels for CUDA tensors and the tensor path for CPU tensors.
The kernels take only coefficient (2, 1) and H, W % 8 == 0; every other
shape takes the tensor path under every backend.  That is the reference's
own dispatch (``DctQim._use_fused``, where the Pallas kernels take the same
shapes and the rest goes to XLA), not a fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.fused_dct_qim import fused_dct_qim_extract, fused_dct_qim_mark, true_div
from ..ops.color import M_BWD, bgr_to_yuv, yuv_to_bgr
from ..ops.soa import dct_soa, idct_soa, image_to_soa, soa_to_image
from .dwt_dct_svd import REFERENCE_BACKENDS

BACKENDS = ("auto", "kernel", "torch")


def _block_grid8(h: int, w: int):
    return h // 8, w // 8


def luminance_mask(y_soa_dc: torch.Tensor) -> torch.Tensor:
    """[B, N] block DC values (orthonormal DCT [0,0]) -> luminance mask."""
    v = true_div(y_soa_dc, 8.0)
    l_min, l_max, f_max = 90.0, 255.0, 2.0
    mean = torch.clamp(v.mean(dim=1, keepdim=True), min=l_min)
    f_ref = 1.0 + true_div((mean - l_min) * (f_max - 1.0), l_max - l_min)
    ramp = 1.0 + (v - mean) / (l_max - mean) * (f_max - f_ref)
    one = torch.ones_like(v)
    return torch.where(v > mean, ramp,
                       torch.where(v < 15.0, 1.25 * one, torch.where(v < 25.0, 1.125 * one, one)))


def texture_mask(y_dct_soa: torch.Tensor) -> torch.Tensor:
    """[B, 64, N] Y-channel DCT blocks (SoA) -> texture mask [B, N]."""
    c = y_dct_soa.abs()

    def at(r, col):
        return c[:, r * 8 + col, :]

    dcl = at(0, 0) + at(0, 1) + at(0, 2) + at(1, 0) + at(1, 1) + at(2, 0)
    eh = c.sum(dim=1) - dcl
    e = (at(3, 0) + at(4, 0) + at(5, 0) + at(6, 0) + at(0, 3) + at(0, 4) + at(0, 5) + at(0, 6)
         + at(2, 1) + at(1, 2) + at(2, 2) + at(3, 3))
    h = eh - e
    l = dcl - at(0, 0)
    l_e = l / e
    le_h = (l + e) / h
    a1, b1 = 2.3, 1.6
    a2, b2 = 1.4, 1.1

    def edge(a, b):
        return ((l_e >= a) & (le_h >= b)) | ((l_e >= b) & (le_h >= a)) | (le_h > 4.0)

    one = torch.ones_like(eh)
    edge_val = torch.where(l + e <= 400.0, 1.125 * one, 1.25 * one)
    ramp = 1.0 + true_div(1.25 * (eh - 290.0), 1800.0 - 290.0)
    hi = torch.where(edge(a2, b2), edge_val, ramp)
    lo = torch.where(edge(a1, b1), edge_val, torch.where(e + h > 290.0, ramp, one))
    return torch.where(eh > 125.0, torch.where(eh > 900.0, hi, lo), one)


@dataclass(frozen=True)
class DctQim:
    """Functional perceptual DCT-QIM codec; frozen and hashable."""

    alpha: float = 20.0
    blk: int = 8
    # DCT coefficient carrying the bit
    coeff_row: int = 2
    coeff_col: int = 1
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        object.__setattr__(self, "alpha", float(self.alpha))

    @classmethod
    def from_reference(cls, obj) -> "DctQim":
        """This codec configured as a ``vfp_tpu`` DctQim (read by attribute).
        Its ``fast_dots`` is ignored: the port computes in float32, and the
        JAX package documents its bf16 passes as decision-equivalent."""
        return cls(alpha=float(obj.alpha), blk=int(obj.blk), coeff_row=int(obj.coeff_row),
                   coeff_col=int(obj.coeff_col), backend=REFERENCE_BACKENDS[obj.backend])

    def wm_capacity(self, frame_shape):
        return (1, frame_shape[0] * frame_shape[1] // 64)

    def _use_kernel(self, frames: torch.Tensor) -> bool:
        """Whether [B, H, W, 3] ``frames`` take the fused kernels."""
        if self.backend == "torch" or (self.backend == "auto" and not frames.is_cuda):
            return False
        h, w = frames.shape[1], frames.shape[2]
        return (self.coeff_row, self.coeff_col) == (2, 1) and h % 8 == 0 and w % 8 == 0

    def _masks(self, y: torch.Tensor) -> torch.Tensor:
        """[B, H, W] Y channel -> combined step mask [B, N]."""
        y_dct = dct_soa(image_to_soa(y, self.blk))
        return texture_mask(y_dct) * luminance_mask(y_dct[:, 0, :])

    # -- YUV-level API ------------------------------------------------------------
    def encode_yuv(self, yuv: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = yuv.shape
        nbh, nbw = _block_grid8(h, w)
        u_new = self._embed_channel(yuv[..., 0], yuv[..., 1], wm)
        out = yuv.clone()
        out[:, : nbh * 8, : nbw * 8, 1] = u_new
        return out

    def _embed_channel(self, y: torch.Tensor, u: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        """Returns the marked (cropped to 8-aligned) U channel region."""
        b, h, w = u.shape
        nbh, nbw = _block_grid8(h, w)
        h8, w8 = nbh * 8, nbw * 8
        mask = self._masks(y[:, :h8, :w8])  # [B, N]
        m = dct_soa(image_to_soa(u[:, :h8, :w8], self.blk))  # [B, 64, N]
        idx = self.coeff_row * 8 + self.coeff_col
        v = m[:, idx, :]
        bits = wm.reshape(-1)[: nbh * nbw].to(torch.float32)[None, :]
        step = self.alpha * mask
        step2 = step + step
        base = torch.sign(v) * torch.floor(v.abs() / step2) * step2
        v_new = torch.where(bits == 0, base, base + torch.sign(v) * step)
        m = m.clone()
        m[:, idx, :] = v_new
        return soa_to_image(idct_soa(m), h8, w8, self.blk)

    def decode_yuv(self, yuv: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, capacity] decoded bits (f32 0/1, zero-padded to capacity)."""
        b, h, w, _ = yuv.shape
        nbh, nbw = _block_grid8(h, w)
        h8, w8 = nbh * 8, nbw * 8
        mask = self._masks(yuv[:, :h8, :w8, 0])
        m = dct_soa(image_to_soa(yuv[:, :h8, :w8, 1], self.blk))
        idx = self.coeff_row * 8 + self.coeff_col
        step = self.alpha * mask
        # floor-mod, as jnp.mod
        bits = (torch.remainder(torch.round(m[:, idx, :] / step), 2.0) == 1.0).to(torch.float32)
        return torch.nn.functional.pad(bits, (0, h * w // 64 - nbh * nbw))

    # -- uint8 frame-level API ------------------------------------------------------
    def mark_frames(self, frames: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> marked uint8.  The tensor path is the
        reference's frame path (YUV2BGR is affine in the U delta, so the
        output is the colour roundtrip plus delta * M_BWD[:, 1])."""
        b, h, w, _ = frames.shape
        nbh, nbw = _block_grid8(h, w)
        h8, w8 = nbh * 8, nbw * 8
        if self._use_kernel(frames):
            wm2d = wm.reshape(-1)[: nbh * nbw].reshape(nbh, nbw).to(torch.float32).contiguous()
            out = fused_dct_qim_mark(frames.permute(0, 3, 1, 2), wm2d, self.alpha)
            return out.permute(0, 2, 3, 1)
        yuv = bgr_to_yuv(frames.to(torch.float32))
        u = yuv[..., 1]
        u_new = self._embed_channel(yuv[..., 0], u, wm)
        delta = torch.zeros_like(u)
        delta[:, :h8, :w8] = u_new - u[:, :h8, :w8]
        bwd = torch.as_tensor(M_BWD[:, 1], device=frames.device)
        marked = yuv_to_bgr(yuv) + delta[..., None] * bwd
        return torch.round(torch.clamp(marked, 0.0, 255.0)).to(torch.uint8)

    def extract_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> [B, capacity] decoded bit plane (f32 0/1)."""
        if self._use_kernel(frames):
            b, h, w, _ = frames.shape
            nbh, nbw = _block_grid8(h, w)
            bits = fused_dct_qim_extract(frames.permute(0, 3, 1, 2), self.alpha)
            bits = bits.reshape(b, nbh * nbw)
            return torch.nn.functional.pad(bits, (0, h * w // 64 - nbh * nbw))
        return self.decode_yuv(bgr_to_yuv(frames.to(torch.float32)))
