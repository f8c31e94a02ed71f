"""DT-CWT keyed spread-spectrum watermark codec on frame batches (port of
``vfp_tpu/wm/dtcwt_codecs.py``, the ``DtcwtKey`` variant).

Marking: 6 per-subband perceptual masks from the 2x2-mean-filtered
|level-2 Y highpasses|, rebinned to the level-3 grid and quantized by
``step``; the watermark plane's level-1 DT-CWT highpasses are replicated into
the 4 corners of each level-3 subband and added scaled by ``alpha * mask``.
The transform is linear and the delta lives only in the level-3 highpasses,
so the marked frame is x + du * M_BWD[:, 1] with du the synthesis of the
delta alone: the U channel is never analysed.  Detection divides the
level-3 U highpasses by ``mask * alpha``, folds the 4 corner replicas, and
inverts a 1-level pyramid with a zero lowpass.

``backend``: ``"kernel"`` (and ``"auto"`` for CUDA tensors) runs both
directions on the CUDA kernels (their plain versions for CPU tensors).
Marking: ``dtcwt_level1_ll_y`` (u8 frames -> Y tree lowpasses),
``dtcwt_qshift_masks`` (-> quantized masks), ``dtcwt_delta_synthesis``
(delta planes -> pixel delta), and ``dtcwt_level1_analysis`` for the
watermark plane's spectrum (through ``Transform2d.forward``, every batch, as
the JAX package's traced path does).  Detection, as the JAX package's
chained path (``_decode_from_ll1_chain``): ``dtcwt_level1_ll_color`` (u8
frames -> Y and U tree lowpasses), ``dtcwt_qshift_ll`` then
``dtcwt_qshift_hp`` on the U half (-> level-3 highpasses),
``dtcwt_qshift_masks`` on the Y half (both halves read in place), and
``dtcwt_legall_synthesis_hp`` after the glue (q2c, divide by mask and alpha,
fold the corners, c2q).  The kernels take H, W % 8 == 0, the geometry where
every level halves exactly and the JAX codec takes its fused kernels; other
shapes raise there.  ``"torch"`` (and ``"auto"`` for CPU tensors) runs the
tensor path below, the JAX package's XLA path.  The codec has 3 levels, as
the JAX package's default; other depths and the image variant (mask
normalisation) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.dtcwt_delta import dtcwt_delta_synthesis
from ..kernels.dtcwt_level1 import (dtcwt_level1_ll_color, dtcwt_level1_ll_y, dtcwt_qshift_hp,
                                    dtcwt_qshift_ll)
from ..kernels.dtcwt_masks import dtcwt_qshift_masks
from ..kernels.dtcwt_synthesis import dtcwt_legall_synthesis_hp
from ..kernels.fused_dct_qim import true_div
from ..ops.color import M_BWD, bgr_to_yuv
from ..ops.dtcwt import Transform2d, c2q_subs, q2c_magnitudes, q2c_planes
from ..ops.filters import filter2d_mean2x2, rebin_mean

BACKENDS = ("auto", "kernel", "torch")


def infer_wm_shape(img_shape):
    """Watermark plane dims for a frame: the level-3 grid, rounded up to even."""
    h = (((img_shape[0] + 1) // 2 + 1) // 2 + 1) // 2
    w = (((img_shape[1] + 1) // 2 + 1) // 2 + 1) // 2
    return (h + h % 2, w + w % 2)


def _corner_replicate(coeff: torch.Tensor, shape) -> torch.Tensor:
    """Place [..., h, w] coeffs into the 4 corners of a [..., H, W] zero plane
    by assignment in the order [:h, :w], [-h:, :w], [:h, -w:], [-h:, -w:]:
    where corners overlap, the later one wins."""
    h, w = coeff.shape[-2], coeff.shape[-1]
    out = coeff.new_zeros((*coeff.shape[:-2], *shape))
    out[..., :h, :w] = coeff
    out[..., -h:, :w] = coeff
    out[..., :h, -w:] = coeff
    out[..., -h:, -w:] = coeff
    return out


def _fold_corners(coeff: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sum the 4 corner [h, w] windows."""
    return (coeff[..., :h, :w] + coeff[..., :h, -w:] + coeff[..., -h:, :w]
            + coeff[..., -h:, -w:])


@dataclass(frozen=True)
class _DtcwtBase:
    alpha: float = 10.0
    step: float = 5.0
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        object.__setattr__(self, "alpha", float(self.alpha))
        object.__setattr__(self, "step", float(self.step))

    @classmethod
    def from_reference(cls, obj):
        """This codec configured as a ``vfp_tpu`` DT-CWT codec (read by
        attribute).  Its ``fast_dots`` is ignored: the port computes in
        float32."""
        if int(obj.nlevels) != 3 or bool(obj.normalize_masks):
            raise NotImplementedError("only 3 levels without mask normalisation are ported "
                                      "(ROADMAP.md queue 1)")
        return cls(alpha=float(obj.alpha), step=float(obj.step))

    def wm_capacity(self, frame_shape):
        return infer_wm_shape(frame_shape)

    def _use_kernel(self, frames: torch.Tensor) -> bool:
        if self.backend == "torch" or (self.backend == "auto" and not frames.is_cuda):
            return False
        h, w = frames.shape[1], frames.shape[2]
        if h % 8 or w % 8:
            raise NotImplementedError(
                f"the DT-CWT kernels take H, W % 8 == 0, got {h}x{w}; the 3-stage "
                "synthesis kernels that other shapes need are not ported yet (ROADMAP.md "
                "queue 1); pass backend='torch' for the tensor path")
        return True

    # -- watermark spectrum ------------------------------------------------------------
    def wm_highpass(self, wm: torch.Tensor) -> torch.Tensor:
        """Level-1 DT-CWT highpasses of the watermark plane [h, w] -> complex
        [h/2, w/2, 6]."""
        return Transform2d(self.backend).forward(wm.to(torch.float32), nlevels=1).highpasses[0]

    # -- masks and delta ---------------------------------------------------------------
    def _masks3_from_mags(self, mags: torch.Tensor, shape3):
        """[B, 6, h2, w2] subband magnitudes -> [B, 6, h3, w3] masks."""
        return torch.ceil(true_div(rebin_mean(filter2d_mean2x2(mags), shape3), self.step))

    def _delta_subs(self, masks: torch.Tensor, wm_hp: torch.Tensor) -> torch.Tensor:
        """[B, 6, h3, w3] masks + complex [h, w, 6] watermark spectrum -> the
        level-3 delta planes [B, 12, h3, w3] [lh*4, hl*4, hh*4]."""
        wm_plane = _corner_replicate(wm_hp.permute(2, 0, 1), masks.shape[-2:])
        delta6 = (self.alpha * masks) * wm_plane[None]  # [B, 6, h3, w3] complex
        return c2q_subs(delta6.permute(0, 2, 3, 1))

    def _embed_delta_torch(self, y: torch.Tensor, wm_hp: torch.Tensor) -> torch.Tensor:
        """Y channel [B, H, W] -> pixel-space U delta [B, H, W] on the tensor
        path: level 1 lowpass-only, level 2 highpass-only (the masks), then
        the delta synthesis with the inter-level crops of odd shapes."""
        t = Transform2d("torch")
        y_ll1, s0 = t.analysis_level1(y, lowpass_only=True)
        y_hp2, s1 = t.analysis_qshift_hp(y_ll1)
        h2, w2 = y_hp2.shape[-2], y_hp2.shape[-1]
        shape3 = ((h2 + 1) // 2, (w2 + 1) // 2)
        dsubs = self._delta_subs(self._masks3_from_mags(q2c_magnitudes(y_hp2), shape3), wm_hp)
        d3 = torch.cat([dsubs.new_zeros((*dsubs.shape[:-3], 4, *shape3)), dsubs], dim=-3)
        dll2 = t.synthesis_qshift(d3)[..., :h2, :w2]
        dll1 = t.synthesis_qshift_ll(dll2)[..., : s1[0], : s1[1]]
        return t.synthesis_legall_ll(dll1)[..., : s0[0], : s0[1]]

    # -- uint8 frame API -------------------------------------------------------------------
    def mark_frames(self, frames: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 + watermark plane [h, w] (or flattened) -> marked
        uint8: round(clip(x + du * M_BWD[:, 1], 0, 255)), half to even."""
        h, w = frames.shape[1], frames.shape[2]
        wm_hp = self.wm_highpass(wm.reshape(self.wm_capacity((h, w, 3))))
        bwd = torch.as_tensor(M_BWD[:, 1], device=frames.device)
        f32 = frames.to(torch.float32)
        if self._use_kernel(frames):
            masks = dtcwt_qshift_masks(dtcwt_level1_ll_y(frames), self.step)
            du = dtcwt_delta_synthesis(self._delta_subs(masks, wm_hp))[..., :h, :w]
            marked = f32 + du[..., None] * bwd
        else:
            yuv = bgr_to_yuv(f32)
            u = yuv[..., 1]
            u_new = u + self._embed_delta_torch(yuv[..., 0], wm_hp)
            marked = f32 + (u_new - u)[..., None] * bwd
        return torch.round(torch.clamp(marked, 0.0, 255.0)).to(torch.uint8)

    def extract_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> recovered watermark planes [B, h, w]."""
        if self._use_kernel(frames):
            ll = dtcwt_level1_ll_color(frames)  # [B, 2, 4, H/2, W/2]
            u_hp3 = dtcwt_qshift_hp(dtcwt_qshift_ll(ll[:, 1]))  # [B, 12, H/8, W/8]
            masks = dtcwt_qshift_masks(ll[:, 0], self.step)
            return self._decode_coeffs(u_hp3, masks, dtcwt_legall_synthesis_hp)
        yuv = bgr_to_yuv(frames.to(torch.float32))
        return self._decode_channel(yuv[..., 0], yuv[..., 1])

    def _decode_channel(self, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Y level-2 subbands (masks) and U level-3 subbands (coefficients);
        every other analysis level runs lowpass-only."""
        b = y.shape[0]
        t = Transform2d("torch")
        ll1, _ = t.analysis_level1(torch.cat([y, u], dim=0), lowpass_only=True)
        u_ll2, _ = t.analysis_qshift(ll1[b:], lowpass_only=True)
        u_hp3, _ = t.analysis_qshift_hp(u_ll2)
        y_hp2, _ = t.analysis_qshift_hp(ll1[:b])
        masks = self._masks3_from_mags(q2c_magnitudes(y_hp2), u_hp3.shape[-2:])
        return self._decode_coeffs(u_hp3, masks, t.synthesis_legall_hp)

    def _decode_coeffs(self, u_hp3: torch.Tensor, masks: torch.Tensor, synthesis):
        """U level-3 highpasses [B, 12, h3, w3] and masks [B, 6, h3, w3] ->
        the recovered planes: the decoder's 0 -> 0.01 mask guard, q2c,
        division by mask and alpha, the fold of the 4 corner replicas, c2q,
        and ``synthesis`` (the highpass-only LeGall level-1 synthesis)."""
        masks = torch.where(masks == 0, torch.full_like(masks, 0.01), masks)
        coeff = q2c_planes(u_hp3) / masks.permute(0, 2, 3, 1).to(torch.complex64)
        coeff = coeff / torch.full_like(coeff, self.alpha)
        hh, ww = (u_hp3.shape[-2] + 1) // 2, (u_hp3.shape[-1] + 1) // 2
        folded = _fold_corners(coeff.permute(0, 3, 1, 2), hh, ww).permute(0, 2, 3, 1)
        return synthesis(c2q_subs(folded))


@dataclass(frozen=True)
class DtcwtKey(_DtcwtBase):
    """Keyed spread-spectrum variant; pairs with CorrShuffler/DeCorrShuffler."""

    alpha: float = 10.0
