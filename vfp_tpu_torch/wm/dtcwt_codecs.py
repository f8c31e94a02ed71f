"""DT-CWT watermark codecs on frame batches (port of
``vfp_tpu/wm/dtcwt_codecs.py``): the keyed spread-spectrum ``DtcwtKey`` and
the image-payload ``DtcwtImg``.

Marking: 6 per-subband perceptual masks from the 2x2-mean-filtered
|level-2 Y highpasses|, rebinned to the level-3 grid and quantized by
``step``; the watermark plane's level-1 DT-CWT highpasses are replicated into
the 4 corners of each level-3 subband and added scaled by ``alpha * mask``.
The transform is linear and the delta lives only in the level-3 highpasses,
so the marked frame is x + du * M_BWD[:, 1] with du the synthesis of the
delta alone: the U channel is never analysed.  Detection divides the
level-3 U highpasses by ``mask * alpha``, folds the 4 corner replicas, and
inverts a 1-level pyramid with a zero lowpass.

Frame dtype and shape pick the path, as in the JAX package.  uint8 frames
with even H and W at 3 levels take the color-fused level-1 kernels
(``dtcwt_level1_ll_y`` to mark, ``dtcwt_level1_ll_color`` to detect: Y and U
tree lowpasses straight from the bytes); everything else (float frames, odd
H or W, other depths) converts with ``bgr_to_yuv`` and takes the channel
path through ``Transform2d``.  From the level-1 tree lowpasses on, one
geometric test picks the rest: where the level-1 grid is a multiple of 4 on
both axes (H, W % 8 == 0 for even frames), every level halves exactly and
the fused kernels run, ``dtcwt_qshift_masks`` and ``dtcwt_delta_synthesis``;
elsewhere the masks are tensor glue on the level-2 highpasses
(``q2c_magnitudes``, the 2x2 mean filter, ``rebin_mean`` with its odd-H zero
row) and the delta takes the three synthesis stages with the inter-level
crops.  Detection runs the U channel's levels 2 (lowpass-only) and 3
(highpass-only), the masks the same way, the glue on the level-3 grid (q2c,
division by mask and alpha, the fold of the corner replicas, c2q) and the
highpass-only LeGall synthesis.  At ``nlevels != 3`` both directions take
the full raw pyramid of Y and U (``Transform2d.forward_raw`` /
``inverse_raw``); the JAX codec detects its own mark only at 3 levels, and
so does this one.

``backend``: ``"kernel"`` (and ``"auto"`` for CUDA tensors) runs every
transform block and fused stage on the CUDA kernels (their plain versions
for CPU tensors); ``"torch"`` (and ``"auto"`` for CPU tensors) runs the
plain transform and the glue path everywhere, the JAX package's XLA path.
``DtcwtImg`` (``alpha=1.5``, ``normalize_masks=True``) runs the same kernels
and glue; its masks are divided by ``max(12, amax)`` of each subband plane
of each frame before they scale the delta (every mark path builds its delta
in ``_delta_subs``) and, after the decoder's 0 -> 0.01 guard, before they
divide the coefficients (every detect path decodes in ``_decode_coeffs``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from ..kernels.dtcwt_delta import dtcwt_delta_synthesis
from ..kernels.dtcwt_level1 import dtcwt_level1_ll_color, dtcwt_level1_ll_y
from ..kernels.dtcwt_masks import dtcwt_qshift_masks
from ..kernels.fused_dct_qim import true_div
from ..ops.color import M_BWD, bgr_to_yuv
from ..ops.dtcwt import Transform2d, c2q_subs, q2c_magnitudes, q2c_planes
from ..ops.filters import filter2d_mean2x2, rebin_mean
from ..utils import profiling

BACKENDS = ("auto", "kernel", "torch")

# The watermark plane's level-1 spectrum, computed once per distinct plane
# (``_DtcwtBase.wm_hp_device``): an identity cache in front, keyed by the
# tensor that owns the plane's memory (the view's base, or the tensor
# itself), where in it the plane lies, its version counter and its device,
# and a content cache behind it, keyed by the plane's bytes.  At most 8
# entries each.
_WM_CACHE_SIZE = 8
_WM_ID_CACHE: dict = {}
_WM_HP_CACHE: dict = {}
_WM_LOCK = threading.Lock()  # held while the caches are read and filled
# ``M_BWD[:, 1]`` (float32) on each device a mark has run on, uploaded at
# the first mark there.
_BWD_U: dict = {}


def clear_wm_cache() -> None:
    """Forget every cached watermark spectrum (both caches)."""
    _WM_ID_CACHE.clear()
    _WM_HP_CACHE.clear()


def _cache_put(cache: dict, key, value) -> None:
    if len(cache) >= _WM_CACHE_SIZE:
        cache.clear()
    cache[key] = value


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
    nlevels: int = 3
    backend: str = "auto"
    normalize_masks: bool = False  # True for the image variant

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if int(self.nlevels) < 2:
            raise ValueError(f"nlevels must be >= 2 (the masks read level 2), got "
                             f"{self.nlevels}")
        object.__setattr__(self, "alpha", float(self.alpha))
        object.__setattr__(self, "step", float(self.step))
        object.__setattr__(self, "nlevels", int(self.nlevels))
        object.__setattr__(self, "normalize_masks", bool(self.normalize_masks))

    @classmethod
    def from_reference(cls, obj):
        """This codec configured as a ``vfp_tpu`` DT-CWT codec (read by
        attribute), its mask normalisation included.  Its ``fast_dots`` is
        ignored: the port computes in float32."""
        return cls(alpha=float(obj.alpha), step=float(obj.step), nlevels=int(obj.nlevels),
                   normalize_masks=bool(obj.normalize_masks))

    def wm_capacity(self, frame_shape):
        return infer_wm_shape(frame_shape)

    def _kernel_mode(self, x: torch.Tensor) -> bool:
        return self.backend == "kernel" or (self.backend == "auto" and x.is_cuda)

    def _u8_kernel_path(self, frames: torch.Tensor) -> bool:
        """uint8 frames with even H and W at 3 levels: the color-fused level-1
        kernels."""
        return (self.nlevels == 3 and frames.dtype == torch.uint8 and self._kernel_mode(frames)
                and frames.shape[1] % 2 == 0 and frames.shape[2] % 2 == 0)

    def _fused(self, y_ll1: torch.Tensor) -> bool:
        """Exact level geometry above level 1 (h1, w1 % 4 == 0) on the kernel
        path: the fused masks and delta kernels."""
        return (self._kernel_mode(y_ll1) and y_ll1.shape[-2] % 4 == 0
                and y_ll1.shape[-1] % 4 == 0)

    # -- watermark spectrum ------------------------------------------------------------
    def wm_highpass(self, wm: torch.Tensor) -> torch.Tensor:
        """Level-1 DT-CWT highpasses of the watermark plane [h, w] -> complex
        [h/2, w/2, 6]."""
        return Transform2d(self.backend).forward(wm.to(torch.float32), nlevels=1).highpasses[0]

    def wm_hp_device(self, hw, wm: torch.Tensor) -> torch.Tensor:
        """``wm_highpass`` of the plane for frames of size ``hw``, cached: the
        watermark is fixed across a run, so its spectrum is computed once per
        distinct plane (the JAX codec's ``wm_hp_device``).  The identity key
        names the tensor that owns the plane's memory (``wm._base`` for a
        view) and where the plane lies in it, so the fresh view of the same
        plane that each batch call passes (``FrameMarker``'s ``wm[None]``,
        each of ``MultiMarker``'s variants) hits without reading the plane
        back; it carries the version counter that views share with their
        base, so an in-place edit through any of them misses.  An inference
        tensor has no version counter and goes to the content cache, as
        does an equal plane in another tensor."""
        mode = self._kernel_mode(wm)
        hw = (int(hw[0]), int(hw[1]))
        idk = owner = None
        if not wm.is_inference():
            owner = wm if wm._base is None else wm._base
            idk = (mode, hw, id(owner), wm.storage_offset(), tuple(wm.shape), wm.stride(),
                   wm.dtype, wm._version, wm.device)
        with _WM_LOCK:  # calls in flight at once compute a new plane's spectrum once
            hit = _WM_ID_CACHE.get(idk)
            if hit is not None and hit[0] is owner:
                return hit[1]
            # the frame size fixes the plane's shape, so its bytes alone name it
            with profiling.sync_span("sync.wm_spectrum", wm):
                plane = wm.detach().to("cpu", torch.float32).contiguous()
            ck = (mode, hw, wm.device, plane.numpy().tobytes())
            spectrum = _WM_HP_CACHE.get(ck)
            if spectrum is None:
                spectrum = self.wm_highpass(wm.reshape(self.wm_capacity((*hw, 3))))
                _cache_put(_WM_HP_CACHE, ck, spectrum)
            if idk is not None:
                _cache_put(_WM_ID_CACHE, idk, (owner, spectrum))
        return spectrum

    # -- masks and delta ---------------------------------------------------------------
    def _masks3_from_mags(self, mags: torch.Tensor, shape3):
        """[B, 6, h2, w2] subband magnitudes -> [B, 6, h3, w3] masks."""
        return torch.ceil(true_div(rebin_mean(filter2d_mean2x2(mags), shape3), self.step))

    def _finish_masks(self, masks: torch.Tensor, zero_guard: bool = False) -> torch.Tensor:
        """The decoder's 0 -> 0.01 guard (``zero_guard``), then the image
        variant's normalisation ``m / max(12, amax)`` of each [h3, w3] plane,
        a division by a tensor (IEEE on every device).  The guard comes
        first, so flat-luminance coefficients keep the reference's weight."""
        if zero_guard:
            masks = torch.where(masks == 0, torch.full_like(masks, 0.01), masks)
        if self.normalize_masks:
            peak = torch.amax(masks, dim=(-2, -1), keepdim=True)
            masks = masks / torch.clamp(peak, min=12.0)
        return masks

    def _delta_subs(self, masks: torch.Tensor, wm_hp: torch.Tensor) -> torch.Tensor:
        """[B, 6, h3, w3] masks + complex [h, w, 6] watermark spectrum -> the
        level-3 delta planes [B, 12, h3, w3] [lh*4, hl*4, hh*4]."""
        masks = self._finish_masks(masks)
        wm_plane = _corner_replicate(wm_hp.permute(2, 0, 1), masks.shape[-2:])
        delta6 = (self.alpha * masks) * wm_plane[None]  # [B, 6, h3, w3] complex
        return c2q_subs(delta6.permute(0, 2, 3, 1))

    def _embed_delta_from_ll1(self, y_ll1: torch.Tensor, wm_hp: torch.Tensor, s0):
        """Y tree lowpasses [B, 4, h1, w1] -> pixel-space U delta [B, H, W]
        cropped to ``s0``: the fused masks and delta kernels, or level 2
        highpass-only, the mask glue and the three synthesis stages with the
        inter-level crops of odd shapes."""
        if self._fused(y_ll1):
            masks = dtcwt_qshift_masks(y_ll1, self.step)
            du = dtcwt_delta_synthesis(self._delta_subs(masks, wm_hp))
            return du[..., : s0[0], : s0[1]]
        t = Transform2d(self.backend)
        y_hp2, s1 = t.analysis_qshift_hp(y_ll1)
        h2, w2 = y_hp2.shape[-2], y_hp2.shape[-1]
        shape3 = ((h2 + 1) // 2, (w2 + 1) // 2)  # the level-3 grid, level 3 not run
        dsubs = self._delta_subs(self._masks3_from_mags(q2c_magnitudes(y_hp2), shape3), wm_hp)
        d3 = torch.cat([dsubs.new_zeros((*dsubs.shape[:-3], 4, *shape3)), dsubs], dim=-3)
        dll2 = t.synthesis_qshift(d3)[..., :h2, :w2]
        dll1 = t.synthesis_qshift_ll(dll2)[..., : s1[0], : s1[1]]
        return t.synthesis_legall_ll(dll1)[..., : s0[0], : s0[1]]

    def _embed_channel_raw(self, y: torch.Tensor, u: torch.Tensor, wm_hp: torch.Tensor):
        """Y and U channels [B, H, W] -> the marked U channel.  At 3 levels the
        delta is synthesized alone and added (the transform is linear and
        the delta lives in the level-3 highpasses): U is never analysed."""
        if self.nlevels != 3:
            return self._embed_channel_raw_generic(y, u, wm_hp)
        y_ll1, s0 = Transform2d(self.backend).analysis_level1(y, lowpass_only=True)
        return u + self._embed_delta_from_ll1(y_ll1, wm_hp, s0)

    def _embed_channel_raw_generic(self, y, u, wm_hp):
        """nlevels != 3: the full raw pyramid of [Y; U], the delta added to
        U's deepest highpasses, and U's inverse."""
        b = y.shape[0]
        t = Transform2d(self.backend)
        planes, sizes = t.forward_raw(torch.cat([y, u], dim=0), self.nlevels)
        top = planes[-1]
        masks = self._masks3_from_mags(q2c_magnitudes(planes[1][:b]), top.shape[-2:])
        u_planes = [p[b:] for p in planes]
        u_planes[-1] = torch.cat([top[b:, :4], top[b:, 4:] + self._delta_subs(masks, wm_hp)],
                                 dim=-3)
        return t.inverse_raw(u_planes, sizes)

    # -- frame API ---------------------------------------------------------------------
    def mark_frames(self, frames: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 (or float) + watermark plane [h, w] (or
        flattened) -> marked uint8: round(clip(x + du * M_BWD[:, 1], 0, 255)),
        half to even."""
        return self._mark(frames, self.wm_hp_device((frames.shape[1], frames.shape[2]), wm))

    def mark_frames_hp(self, frames: torch.Tensor, wm_hp_ri: torch.Tensor) -> torch.Tensor:
        """``mark_frames`` with the watermark spectrum precomputed: ``wm_hp_ri``
        [2, h/2, w/2, 6] holds the real and imaginary planes of
        ``wm_hp_device``'s spectrum, as the JAX codec's ``wm_hp_device`` gives
        them.  The same kernels as ``mark_frames``, the spectrum's excepted."""
        return self._mark(frames, torch.complex(wm_hp_ri[0].to(torch.float32),
                                                wm_hp_ri[1].to(torch.float32)))

    def _mark(self, frames: torch.Tensor, wm_hp: torch.Tensor) -> torch.Tensor:
        h, w = frames.shape[1], frames.shape[2]
        bwd = _BWD_U.get(frames.device)
        if bwd is None:
            with profiling.sync_span("sync.constant_upload", frames):
                bwd = _BWD_U[frames.device] = torch.as_tensor(M_BWD[:, 1], device=frames.device)
        f32 = frames.to(torch.float32)
        if self._u8_kernel_path(frames):
            du = self._embed_delta_from_ll1(dtcwt_level1_ll_y(frames), wm_hp, (h, w))
            marked = f32 + du[..., None] * bwd
        else:
            yuv = bgr_to_yuv(f32)
            u = yuv[..., 1]
            u_new = self._embed_channel_raw(yuv[..., 0], u, wm_hp)
            marked = f32 + (u_new - u)[..., None] * bwd
        return torch.round(torch.clamp(marked, 0.0, 255.0)).to(torch.uint8)

    def extract_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 (or float) -> recovered watermark planes [B, h, w]."""
        if self._u8_kernel_path(frames):
            ll = dtcwt_level1_ll_color(frames)  # [B, 2, 4, H/2, W/2], both halves read in place
            return self._decode_from_ll1(ll[:, 0], ll[:, 1])
        yuv = bgr_to_yuv(frames.to(torch.float32))
        return self._decode_channel_raw(yuv[..., 0], yuv[..., 1])

    def _decode_channel_raw(self, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Y level-2 subbands (masks) and U level-3 subbands (coefficients);
        every other analysis level runs lowpass-only."""
        if self.nlevels != 3:
            return self._decode_channel_raw_generic(y, u)
        b = y.shape[0]
        ll1, _ = Transform2d(self.backend).analysis_level1(torch.cat([y, u], dim=0),
                                                           lowpass_only=True)
        return self._decode_from_ll1(ll1[:b], ll1[b:])

    def _decode_from_ll1(self, y_ll1: torch.Tensor, u_ll1: torch.Tensor) -> torch.Tensor:
        t = Transform2d(self.backend)
        u_ll2, _ = t.analysis_qshift(u_ll1, lowpass_only=True)
        u_hp3, _ = t.analysis_qshift_hp(u_ll2)
        if self._fused(y_ll1):
            masks = dtcwt_qshift_masks(y_ll1, self.step)
        else:
            y_hp2, _ = t.analysis_qshift_hp(y_ll1)  # masks never read the ll band
            masks = self._masks3_from_mags(q2c_magnitudes(y_hp2), u_hp3.shape[-2:])
        return self._decode_coeffs(u_hp3, masks, t.synthesis_legall_hp)

    def _decode_channel_raw_generic(self, y, u):
        b = y.shape[0]
        t = Transform2d(self.backend)
        planes, _ = t.forward_raw(torch.cat([y, u], dim=0), self.nlevels)
        top = planes[-1]
        masks = self._masks3_from_mags(q2c_magnitudes(planes[1][:b]), top.shape[-2:])
        return self._decode_coeffs(top[b:], masks, t.synthesis_legall_hp)

    def _decode_coeffs(self, u_hp3: torch.Tensor, masks: torch.Tensor, synthesis):
        """U's deepest highpasses [B, 12 (or 16), h3, w3] and masks [B, 6, h3,
        w3] -> the recovered planes: the decoder's 0 -> 0.01 mask guard and
        the image variant's normalisation, q2c, division by mask and alpha,
        the fold of the 4 corner replicas, c2q, and ``synthesis`` (the
        highpass-only LeGall level-1 synthesis)."""
        masks = self._finish_masks(masks, zero_guard=True)
        coeff = q2c_planes(u_hp3) / masks.permute(0, 2, 3, 1).to(torch.complex64)
        coeff = coeff / torch.full_like(coeff, self.alpha)
        hh, ww = (u_hp3.shape[-2] + 1) // 2, (u_hp3.shape[-1] + 1) // 2
        folded = _fold_corners(coeff.permute(0, 3, 1, 2), hh, ww).permute(0, 2, 3, 1)
        return synthesis(c2q_subs(folded))


@dataclass(frozen=True)
class DtcwtKey(_DtcwtBase):
    """Keyed spread-spectrum variant; pairs with CorrShuffler/DeCorrShuffler."""

    alpha: float = 10.0


@dataclass(frozen=True)
class DtcwtImg(_DtcwtBase):
    """Visible-image variant: ``alpha=1.5`` and the masks normalised per
    subband plane; pairs with BlockShuffler/DeBlockShuffler."""

    alpha: float = 1.5
    normalize_masks: bool = True
