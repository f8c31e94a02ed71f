"""DWT+DCT+SVD QIM watermark codec on frame batches (port of ``vfp_tpu/wm/dwt_dct_svd.py``).

Per channel with a positive scale (default only U): 1-level Haar DWT of the
frame cropped to a multiple of 4, then for every 4x4 block of the LL band
``s0' = (s0 // scale + 0.25 + 0.5 * bit) * scale`` on the block's dominant
singular value; extraction reads ``bit = (s0 % scale) > scale / 2``.  The
reference's per-block DCT is an orthogonal similarity and leaves the
triplet unchanged, so it is omitted on every path (the JAX module's
docstring has the proof).

Parity quirks kept on purpose: capacity is ``H*W // 64``; the DWT runs on the
4-aligned crop; decoded bits are zero-padded to capacity; LL rows and
columns past the block grid are never modified.

``backend``: ``"kernel"`` takes the CUDA kernels of ``kernels/`` (their plain
versions for CPU tensors), ``"torch"`` the plain tensor path that mirrors the
JAX ``"xla"`` path, ``"auto"`` the kernels for CUDA tensors and the plain
path for CPU tensors.  The two paths compute the triplet and the colour
epilogue differently, exactly as the JAX package's two paths do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.color import M_BWD, M_FWD, OFF_BWD, OFF_FWD, bgr_to_yuv, yuv_to_bgr
from ..ops.haar import haar_dwt2, haar_idwt2
from ..ops.soa import image_to_soa, rank1_update_soa, soa_to_image, top_triplet_soa
from ..kernels import qim
from ..kernels.qim import qim_bit, qim_target

BACKENDS = ("auto", "kernel", "torch")
# the JAX codec's backend names -> this codec's
REFERENCE_BACKENDS = {"pallas": "kernel", "xla": "torch", "auto": "auto"}


def block_grid(frame_shape, blk: int = 4):
    """((nbh, nbw), capacity): actual LL block grid and declared capacity."""
    h, w = frame_shape[0], frame_shape[1]
    h4, w4 = h // 4 * 4, w // 4 * 4
    nbh, nbw = (h4 // 2) // blk, (w4 // 2) // blk
    return (nbh, nbw), h * w // 64


@dataclass(frozen=True)
class DwtDctSvd:
    """Functional codec; frozen and hashable, so extractors can be cached by codec."""

    scales: tuple = (0.0, 15.0, 0.0)
    blk: int = 4
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        object.__setattr__(self, "scales", tuple(float(s) for s in self.scales))

    @classmethod
    def from_reference(cls, obj) -> "DwtDctSvd":
        """This codec configured as a ``vfp_tpu`` DwtDctSvd (read by attribute)."""
        if getattr(obj, "int_path", False):
            raise NotImplementedError("int_path is not ported: it measured a wash on the TPU "
                                      "and the f32 path is the reference")
        return cls(scales=tuple(obj.scales), blk=int(obj.blk),
                   backend=REFERENCE_BACKENDS[obj.backend])

    def _use_kernel(self, x: torch.Tensor) -> bool:
        if self.backend == "auto":
            return x.is_cuda
        return self.backend == "kernel"

    def _fused_ok(self, frame_shape) -> bool:
        """Whether the single-launch kernels take this [B, H, W, 3] shape."""
        return self.blk == 4 and frame_shape[2] % 4 == 0

    def wm_capacity(self, frame_shape):
        return (1, frame_shape[0] * frame_shape[1] // 64)

    # -- core per-channel ops (batched [B, H, W], SoA) ------------------------
    def _embed_channel(self, chan: torch.Tensor, wm_bits: torch.Tensor, scale: float):
        b, h, w = chan.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        (nbh, nbw), _ = block_grid((h, w), self.blk)
        ll, lh, hl, hh = haar_dwt2(chan[:, :h4, :w4])
        m = image_to_soa(ll[:, : nbh * self.blk, : nbw * self.blk], self.blk)  # [B, 16, N]
        bits = wm_bits[: nbh * nbw].to(torch.float32)
        if self._use_kernel(chan):
            m = qim.qim_embed_soa(m, bits.contiguous(), scale)
        else:
            s0, u, v = top_triplet_soa(m)
            m = rank1_update_soa(m, qim_target(s0, bits[None, :], scale) - s0, u, v)
        ll = ll.clone()
        ll[:, : nbh * self.blk, : nbw * self.blk] = soa_to_image(
            m, nbh * self.blk, nbw * self.blk, self.blk)
        out = haar_idwt2(ll, lh, hl, hh)
        if (h4, w4) == (h, w):
            return out
        full = chan.clone()
        full[:, :h4, :w4] = out
        return full

    def _decode_channel(self, chan: torch.Tensor, scale: float) -> torch.Tensor:
        b, h, w = chan.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        (nbh, nbw), _ = block_grid((h, w), self.blk)
        ll, *_ = haar_dwt2(chan[:, :h4, :w4])
        return self._decode_ll(ll, nbh, nbw, scale)

    def _decode_ll(self, ll: torch.Tensor, nbh: int, nbw: int, scale: float) -> torch.Tensor:
        m = image_to_soa(ll[:, : nbh * self.blk, : nbw * self.blk], self.blk)
        if self._use_kernel(ll):
            return qim.qim_decode_soa(m, scale)
        s0, _, _ = top_triplet_soa(m)
        return qim_bit(s0, scale)  # [B, N]

    # -- YUV-level API ----------------------------------------------------------
    def encode_yuv(self, yuv: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float YUV + [capacity] watermark bits -> marked YUV."""
        wm_flat = wm.reshape(-1)
        out = yuv
        for c, scale in enumerate(self.scales):
            if scale <= 0:
                continue
            marked = self._embed_channel(out[..., c], wm_flat, float(scale))
            out = out.clone()
            out[..., c] = marked
        return out

    def decode_yuv(self, yuv: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float YUV -> [B, capacity] decoded bit plane (f32 0/1),
        channel 1 zero-padded up to capacity as the reference decoder does."""
        b, h, w, _ = yuv.shape
        (nbh, nbw), capacity = block_grid((h, w), self.blk)
        bits = self._decode_channel(yuv[..., 1], float(self.scales[1]))
        return torch.nn.functional.pad(bits, (0, capacity - nbh * nbw))

    # -- minimal-traffic helpers --------------------------------------------------
    def _ll_from_frames(self, frames_f32: torch.Tensor, chan: int) -> torch.Tensor:
        """LL band of one YUV channel straight from [B, H, W, 3] frames:
        channel value from the 3x3 colour row, Haar LL = 2x2 sum / 2."""
        b, h, w, _ = frames_f32.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        x = frames_f32[:, :h4, :w4, :].permute(0, 3, 1, 2)  # planar [B, 3, h4, w4]
        mf = [float(v) for v in M_FWD[chan]]
        c = mf[0] * x[:, 0] + mf[1] * x[:, 1] + mf[2] * x[:, 2] + float(OFF_FWD[chan])
        return (c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]) * 0.5

    def _region_triplet(self, ll: torch.Tensor):
        """(m [B,16,N], s0, u, v) of the block-aligned LL region."""
        b, hc, wc = ll.shape
        nbh, nbw = hc // self.blk, wc // self.blk
        m = image_to_soa(ll[:, : nbh * self.blk, : nbw * self.blk], self.blk)
        if self._use_kernel(ll):
            s0, u, v = qim.qim_triplet_soa(m)
        else:
            s0, u, v = top_triplet_soa(m)
        return m, s0, u, v

    def _delta_image(self, ds, u, v, ll_shape):
        """ds·u·vᵀ assembled back onto the LL grid (zero outside the region)."""
        b, hc, wc = ll_shape
        nbh, nbw = hc // self.blk, wc // self.blk
        zero = torch.zeros((b, self.blk * self.blk, nbh * nbw), dtype=torch.float32,
                           device=ds.device)
        delta = soa_to_image(rank1_update_soa(zero, ds, u, v),
                             nbh * self.blk, nbw * self.blk, self.blk)
        if (nbh * self.blk, nbw * self.blk) == (hc, wc):
            return delta
        full = torch.zeros(ll_shape, dtype=torch.float32, device=ds.device)
        full[:, : nbh * self.blk, : nbw * self.blk] = delta
        return full

    def _ll_delta(self, ll: torch.Tensor, wm_bits: torch.Tensor, scale: float) -> torch.Tensor:
        """Marked-LL minus LL over the block-aligned region, zero elsewhere,
        assembled directly as ds·u·vᵀ (marked-minus-input would lose the low
        bits of the small delta to cancellation)."""
        b, hc, wc = ll.shape
        nbh, nbw = hc // self.blk, wc // self.blk
        m, s0, u, v = self._region_triplet(ll)
        bits = wm_bits[: nbh * nbw].to(torch.float32)
        return self._delta_image(qim_target(s0, bits[None, :], scale) - s0, u, v, ll.shape)

    def _ll_delta2(self, ll: torch.Tensor, scale: float) -> torch.Tensor:
        """[2, B, hc, wc]: the LL delta under bit=0 and bit=1 for every block,
        from one triplet solve (s0/u/v do not depend on the bit)."""
        m, s0, u, v = self._region_triplet(ll)
        return torch.stack([
            self._delta_image(qim_target(s0, bit, scale) - s0, u, v, ll.shape)
            for bit in (0.0, 1.0)
        ])

    # -- uint8 frame-level API -------------------------------------------------------
    def mark_frames(self, frames: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 (reference channel convention) -> marked uint8.

        The reference frame path: float32 -> BGR2YUV -> encode -> YUV2BGR ->
        clip(0, 255) -> round-half-even -> uint8.  For one active channel only
        the LL band changes, idwt(LL', details) = x + upsample2x2(dLL)/2, and
        YUV2BGR is affine, so the output is the colour roundtrip of the frame
        plus (delta channel) * M_BWD[:, chan].
        """
        active = [c for c, s in enumerate(self.scales) if s > 0]
        if len(active) != 1:
            marked = yuv_to_bgr(self.encode_yuv(bgr_to_yuv(frames.to(torch.float32)), wm))
            return torch.round(torch.clamp(marked, 0.0, 255.0)).to(torch.uint8)

        c = active[0]
        if self._use_kernel(frames) and self._fused_ok(frames.shape):
            from ..kernels.fused_embed import fused_mark_planar

            (nbh, nbw), _ = block_grid(frames.shape[1:3], self.blk)
            wm2d = wm.reshape(-1)[: nbh * nbw].reshape(nbh, nbw).to(torch.float32).contiguous()
            out = fused_mark_planar(frames.permute(0, 3, 1, 2), wm2d, float(self.scales[c]), c)
            return out.permute(0, 2, 3, 1)
        b, h, w, _ = frames.shape
        h4, w4 = h // 4 * 4, w // 4 * 4
        planes = frames.permute(0, 3, 1, 2).to(torch.float32)  # [B, 3, H, W]
        bp, gp, rp = planes[:, 0], planes[:, 1], planes[:, 2]
        mf = [[float(v) for v in row] for row in M_FWD]
        mb = [[float(v) for v in row] for row in M_BWD]

        cp = (mf[c][0] * bp[:, :h4, :w4] + mf[c][1] * gp[:, :h4, :w4]
              + mf[c][2] * rp[:, :h4, :w4] + float(OFF_FWD[c]))
        ll = (cp[:, 0::2, 0::2] + cp[:, 0::2, 1::2] + cp[:, 1::2, 0::2] + cp[:, 1::2, 1::2]) * 0.5
        dll = self._ll_delta(ll, wm.reshape(-1), float(self.scales[c]))
        # each LL delta spreads as delta/2 over its 2x2 quad
        du = dll.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.5
        if (h4, w4) != (h, w):
            du = torch.nn.functional.pad(du, (0, w - w4, 0, h - h4))

        # colour roundtrip (parity with the reference's double cvtColor) plus the delta
        yuv = [mf[k][0] * bp + mf[k][1] * gp + mf[k][2] * rp + float(OFF_FWD[k]) for k in range(3)]
        yuv[c] = yuv[c] + du
        off = [float(v) for v in OFF_BWD]
        out = [
            mb[k][0] * (yuv[0] - off[0]) + mb[k][1] * (yuv[1] - off[1]) + mb[k][2] * (yuv[2] - off[2])
            for k in range(3)
        ]
        marked = torch.stack(out, dim=-1)  # [B, H, W, 3]
        return torch.round(torch.clamp(marked, 0.0, 255.0)).to(torch.uint8)

    def extract_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> [B, capacity] decoded watermark plane (f32 0/1)."""
        b, h, w, _ = frames.shape
        (nbh, nbw), capacity = block_grid((h, w), self.blk)
        scale = float(self.scales[1])
        if self._use_kernel(frames) and self._fused_ok(frames.shape):
            from ..kernels.fused_embed import fused_extract_planar

            bits = fused_extract_planar(frames.permute(0, 3, 1, 2), scale, 1).reshape(b, nbh * nbw)
        else:
            ll = self._ll_from_frames(frames.to(torch.float32), 1)
            bits = self._decode_ll(ll, nbh, nbw, scale)
        return torch.nn.functional.pad(bits, (0, capacity - nbh * nbw))
