"""LL-domain transport for the flagship codec: move LL-band data, not frames
(port of ``vfp_tpu/pipeline/lowlink.py``).

The DWT+DCT+SVD codec only reads the LL band of one YUV channel and only
writes a delta to that band, so the host<->device traffic can be LL-domain:

  up:   LL of the active channel [k, H/4*2, W/4*2]: dithered u8 (wire
        ``u8``) or float16 (wire ``f16``)
  down: QIM LL delta, int8 fixed point /8 [V, k, hc, wc]; for V >= 3 the two
        bit-conditional planes [2, k, hc, wc] instead (a block's delta
        depends on the watermark only through that block's bit, so the host
        selects, and device work and download do not grow with V)

The host computes the LL (``native/lowlink.cpp``: one pass over the u8
frames) and reconstructs the marked frames as ``clip(x + rint(du *
M_BWD[:, chan]))``: for integer inputs the reference's float colour
roundtrip is the identity after rounding, so only the delta term counts.
Extraction sends the LL up and takes back the per-frame payloads.

Policy (``embedder.use_lowlink``): off unless ``VFP_LOWLINK=1`` or
``VFP_LL_WIRE=host`` asks for it; the JAX package turns it on by default
only on a TPU, and the port never runs on one.

Departures from the JAX module:

- ``backend_reachable`` and its probe thread are not ported.  There, an
  unset ``VFP_LL_WIRE`` resolves to ``host`` when the backend does not
  answer in ``VFP_BACKEND_PROBE_S`` seconds: a CPU fallback that hides the
  device.  Here an unset wire is ``u8``, a device that fails raises, and
  ``VFP_BACKEND_PROBE_S`` is not read.  ``VFP_LL_WIRE=host`` stays the
  caller's explicit request for a host-only run, which makes no CUDA call.
- ``PackedTwoPlane`` dispatches a forced partial flush as one call of its
  own size.  The JAX class splits it into power-of-two calls to bound the
  shapes XLA compiles; the kernels here take any batch.
- The host half is the native library's; a build that fails raises.  Its
  NumPy twins (``native/lowlink.py``) run only for a block size other than
  the C functions' 4.

Kept on purpose: ``_FlatAdapt``, the u8 wire's flat-content hysteresis,
decides which route marks a batch, so the port marks flat content as the
JAX package does.  The batches it sends to the host twin are counted
(``LowLinkMarker.host_batches``, ``stage_seconds["host_qim"]``).

Numerics: f16 LL quantization and the int8/8 delta perturb s0 by well under
1% of the QIM bin (scale 15); marked frames may differ from the full-frame
path by +-1 on rounding-boundary pixels, payloads are the same.
"""

from __future__ import annotations

import os
import threading
import time
from functools import lru_cache

import numpy as np
import torch

from ..kernels.qim import qim_target
from ..native import lowlink as native
from ..ops.color import M_BWD, M_FWD, OFF_FWD
from .transfer import STAGING, Pending, download

DLL_Q = native.DLL_Q
WIRES = ("u8", "f16", "host")


def _check_wire(wire: str, name: str = "wire") -> str:
    if wire not in WIRES:
        raise ValueError(f"{name}={wire!r}: expected 'u8', 'f16' or 'host'")
    return wire


def default_wire() -> str:
    """Up-leg wire: ``VFP_LL_WIRE`` (``u8``, ``f16`` or ``host``), ``u8``
    when unset.  ``u8`` ships dithered round(LL / 2), one byte per LL pixel,
    and the collect-time recentring (``recentre_dll``) cancels the
    quantization's effect on the marked frames' QIM centring; ``host`` runs
    the mark and extract math on the host, with no device call."""
    return _check_wire(os.environ.get("VFP_LL_WIRE") or "u8", "VFP_LL_WIRE")


@lru_cache(maxsize=None)
def _dither(hc: int, wc: int) -> np.ndarray:
    """Subtractive-dither phase pattern, 2x2-tiled {0, 0.5, 1, 1.5}.

    Smooth content makes the 16 LL entries of a QIM block quantize with
    identical errors, which shifts the dominant singular value by 4e, up to
    the whole step and past the scale/4 margin.  Offsetting each cell's
    quantization lattice by one of four phases puts 4 cells of every 4x4
    block on each sublattice, so a constant block's mean error is at most
    0.25 and its s0 shift at most 1."""
    i = np.arange(hc)[:, None] % 2
    j = np.arange(wc)[None, :] % 2
    return ((2 * i + j) * 0.5).astype(np.float32)


def _wire_bias(chan: int) -> float:
    """u8 wire bias: chroma LL is signed (U/V LL spans ~[-224, 224]), so it
    is centred by 128 wire units; the luma LL, [0, 511], needs none."""
    return 0.0 if chan == 0 else 128.0


def wire_encode(ll16: np.ndarray, wire: str, chan: int) -> np.ndarray:
    """f16 LL -> wire array (dithered u8 at step 2, or f16 as it is)."""
    if wire == "u8":
        p = _dither(*ll16.shape[-2:])
        return np.clip(np.rint((ll16.astype(np.float32) - p) * 0.5) + _wire_bias(chan),
                       0.0, 255.0).astype(np.uint8)
    return ll16


def _wire_decode(llw: torch.Tensor, chan: int) -> torch.Tensor:
    """Wire tensor -> f32 LL on its device."""
    if llw.dtype == torch.uint8:
        hc, wc = llw.shape[-2:]
        i = torch.arange(hc, device=llw.device)[:, None] % 2
        j = torch.arange(wc, device=llw.device)[None, :] % 2
        p = (2 * i + j).to(torch.float32) * 0.5
        return (llw.to(torch.float32) - _wire_bias(chan)) * 2.0 + p
    return llw.to(torch.float32)


def wire_error(ll16: np.ndarray, llw: np.ndarray, chan: int) -> np.ndarray:
    """E = the host's exact LL (f32) minus the device's wire-decoded view."""
    p = _dither(*ll16.shape[-2:])
    return ll16.astype(np.float32) - ((llw.astype(np.float32) - _wire_bias(chan)) * 2.0 + p)


# -- u8-wire recentring -------------------------------------------------------
#
# The device computes each block's QIM delta from the quantized LL (X - E), so
# the marked frame's s0 lands off-centre by e = u^T E v (to first order).  The
# host knows E, and the delta block is du * u v^T, so for |du| large enough to
# carry the direction the fix is a rescale:
#
#   dll' = dll * (1 - <dll, E> / ||dll||_F^2)     (= (du - e) * u v^T)
#
# Blocks with |du| below WIRE_DU_MIN cannot yield their direction from the
# int8 delta; the host recomputes those from the true LL block.

WIRE_DU_MIN = 0.5  # ||dll||_F (= |du|) below which the rescale is noise

# Direction-reliability gate: the device's singular direction comes from the
# quantized block X - E, so where the content's own AC structure is comparable
# to the wire error's, it is the dither pattern's (high spatial frequency).
# Lossy chroma coding wipes such a delta, while the exact path's delta on flat
# content is DC and survives.  Blocks with AC(X) < GAMMA2 * AC(E) are
# therefore repaired from the true LL as well.
WIRE_DIR_GAMMA2 = 16.0  # content AC rms must exceed 4x the error AC rms


def _check_plane_bits(plane_bits, nb: int, what: str) -> None:
    if np.asarray(plane_bits).shape[-1] < nb:
        raise ValueError(
            f"plane_bits cover {np.asarray(plane_bits).shape[-1]} blocks, frame grid has "
            f"{nb}: watermark generated for a smaller geometry than the frames being {what}")


def recentre_dll(dll_q: np.ndarray, E: np.ndarray, ll16: np.ndarray, blk: int, scale: float,
                 plane_bits: np.ndarray, stats: dict | None = None) -> np.ndarray:
    """u8-wire deltas [P, k, hc, wc] int8 recentred on the true LL's s0
    (block comment above); E / ll16 [k, hc, wc], plane_bits [P, >= nb] each
    plane's block bits.  With ``stats``, records ``repair_frac``: the share
    of blocks the exact-triplet repair recomputed (read by _FlatAdapt)."""
    P, k, hc, wc = dll_q.shape
    _check_plane_bits(plane_bits, (hc // blk) * (wc // blk), "recentred")
    out, small = native.recentre(dll_q, E, np.asarray(ll16, np.float32), blk, WIRE_DU_MIN,
                                 WIRE_DIR_GAMMA2)
    smb = small.astype(bool)
    if stats is not None:
        stats["repair_frac"] = float(smb.mean())
    if smb.any():
        _repair_small_blocks(out, smb, ll16, blk, scale, plane_bits)
    return out


def _repair_small_blocks(out: np.ndarray, small: np.ndarray, ll16: np.ndarray, blk: int,
                         scale: float, plane_bits: np.ndarray) -> None:
    """Recompute the flagged blocks' deltas from the true LL, in place:
    out [P, k, hc, wc] int8, small [P, k, nbh, nbw] bool."""
    if blk == 4:
        native.qim_repair(out, small, ll16, plane_bits, scale)
    else:
        native.qim_repair_reference(out, small, ll16, plane_bits, scale, blk)


# -- host-only transport (wire='host') ----------------------------------------

def host_dll(ll16: np.ndarray, codec, chan: int, plane_bits: np.ndarray) -> np.ndarray:
    """Host twin of the device mark: f16 LL [k, hc, wc] + per-plane block
    bits [P, >= nb] -> int8 QIM LL delta [P, k, hc, wc], with the device
    path's float association, so the decisions agree."""
    scale, blk = float(codec.scales[chan]), codec.blk
    k, hc, wc = ll16.shape
    _check_plane_bits(plane_bits, (hc // blk) * (wc // blk), "marked")
    if blk == 4:
        return native.qim_dll(ll16, plane_bits, scale)
    return native.qim_dll_reference(ll16, plane_bits, scale, blk)


def host_extract_bits(ll16: np.ndarray, codec, chan: int, capacity: int) -> np.ndarray:
    """Host twin of the device extract: f16 LL [k, hc, wc] -> [k, capacity]
    f32 decoded bits, zero-padded past the block grid as decode_yuv pads."""
    scale, blk = float(codec.scales[chan]), codec.blk
    bits = (native.qim_bits(ll16, scale) if blk == 4
            else native.qim_bits_reference(ll16, scale, blk))
    return np.pad(bits.astype(np.float32), ((0, 0), (0, capacity - bits.shape[1])))


def lowlink_ok(codec) -> bool:
    """Whether the transport applies to this codec: the flagship DWT+DCT+SVD
    family with exactly one active channel."""
    scales = getattr(codec, "scales", None)
    if scales is None or not hasattr(codec, "_ll_delta"):
        return False
    return sum(1 for s in scales if s > 0) == 1


def active_channel(codec) -> int:
    return next(c for c, s in enumerate(codec.scales) if s > 0)


def host_ll(frames: np.ndarray, chan: int) -> np.ndarray:
    """[k, H, W, 3] uint8 BGR -> [k, h4/2, w4/2] float16 LL of YUV channel
    ``chan`` (the colour row plus the orthonormal Haar LL, 2x2 sum / 2)."""
    return native.host_ll(frames, M_FWD[chan], float(OFF_FWD[chan]))


@lru_cache(maxsize=None)
def _delta_luts(chan: int):
    """Per-channel int16 tables: wire int8 value -> rounded pixel delta.

    For integer pixels x, clip(rint(x + d)) == clip(x + rint(d)) for every
    wire value and both nonzero channels (no float lands on a .5 boundary),
    so the float reconstruction is an int16 table add."""
    du = np.arange(-128, 128, dtype=np.float32)
    luts = []
    for ch in range(3):
        coef = float(M_BWD[ch, chan])
        luts.append(None if coef == 0.0
                    else np.rint(du * np.float32(coef * 0.5 / DLL_Q)).astype(np.int16))
    return luts


def reconstruct(frames: np.ndarray, dll_q: np.ndarray, chan: int) -> np.ndarray:
    """[k, H, W, 3] uint8 + int8 LL delta [k, hc, wc] -> marked uint8 frames:
    clip(rint(x + upsample2x2(dll) * 0.5 * M_BWD[:, chan])); channels with a
    zero coefficient (R for chan=1) pass through."""
    return native.reconstruct(frames, dll_q, _delta_luts(chan))


def reconstruct_all(frames: np.ndarray, dll_all: np.ndarray, chan: int) -> np.ndarray:
    """[k, H, W, 3] uint8 + [V, k, hc, wc] int8 deltas -> [V, k, H, W, 3],
    each variant written in place."""
    out = np.empty((len(dll_all), *frames.shape), np.uint8)
    for v, d in enumerate(dll_all):
        native.reconstruct(frames, d, _delta_luts(chan), out=out[v])
    return out


# -- device functions ---------------------------------------------------------

def _quantize(dll: torch.Tensor) -> torch.Tensor:
    """f32 LL delta -> int8 fixed point: clip(round(d * 8), -127, 127),
    rounding half to even."""
    return torch.clamp(torch.round(dll * DLL_Q), -127.0, 127.0).to(torch.int8)


@torch.inference_mode()
def _mark(codec, chan: int, llw: torch.Tensor, wms: torch.Tensor) -> torch.Tensor:
    """Wire LL [k, hc, wc] + watermarks [V, cap] on one device -> int8 deltas
    [V, k, hc, wc]: ``codec._ll_delta`` of each variant, the triplet solved
    once for all of them."""
    scale = float(codec.scales[chan])
    ll = _wire_decode(llw, chan)
    _, s0, u, v = codec._region_triplet(ll)
    nb = s0.shape[1]
    return _quantize(torch.stack([
        codec._delta_image(qim_target(s0, wm[:nb][None, :], scale) - s0, u, v, ll.shape)
        for wm in wms]))


@torch.inference_mode()
def _mark_2plane(codec, chan: int, llw: torch.Tensor) -> torch.Tensor:
    """Wire LL [k, hc, wc] -> int8 [2, k, hc, wc]: the QIM delta of every
    block under bit 0 and bit 1, from one triplet solve
    (``codec._ll_delta2``).  Every variant's delta is a per-block selection
    from these two planes, and quantizing then selecting equals selecting
    then quantizing."""
    return _quantize(codec._ll_delta2(_wire_decode(llw, chan), float(codec.scales[chan])))


class _FlatAdapt:
    """u8-wire flat-content hysteresis.

    When a collect's direction gate repaired (almost) every block, the
    device's deltas carried no information for that batch.  After ON_AFTER
    such collects in a row the marker routes submits through the host twin
    (``host_dll``, decision-identical by construction), sending every
    PROBE_EVERY-th batch to the device again so content that regains chroma
    structure moves back.  Scope: one per PackedTwoPlane (shared by a
    workflow's segments) or per unpacked marker, never process-wide."""

    THRESH = 0.9      # repair fraction above which a batch counts as flat
    ON_AFTER = 2      # consecutive flat collects before switching
    PROBE_EVERY = 8   # every Nth host batch goes to the device anyway

    def __init__(self):
        self.streak = 0
        self.host_batches = 0

    def update(self, repair_frac: float) -> None:
        self.streak = self.streak + 1 if repair_frac > self.THRESH else 0

    def use_host(self) -> bool:
        if self.streak < self.ON_AFTER:
            return False
        self.host_batches += 1
        return self.host_batches % self.PROBE_EVERY != 0


class _Chunk:
    """One packed device call: LL pieces from one or more submissions."""

    __slots__ = ("pending", "planes", "once")

    def __init__(self):
        self.pending: Pending | None = None  # the download, after the flush
        self.planes: np.ndarray | None = None  # [2, n, hc, wc] int8, once fetched
        self.once = threading.Lock()


class PackedTwoPlane:
    """Shared two-plane dispatcher: packs the LL submissions of several
    LowLinkMarker instances (one codec, one frame size) into ``pack``-frame
    device calls.  The two-plane delta depends only on the LL, not on any
    segment's watermarks, so one call serves frames of many HLS segments
    and each marker selects its variants on the host afterwards.

    A call is dispatched when ``pack`` frames are pending, or earlier when a
    collect needs a pending frame, the frame size or wire changes, or at
    ``flush``: then with the frames it has.  ``call_frames`` records the
    frames of each device call."""

    def __init__(self, codec, pack: int = 16, wire: str | None = None, *, device):
        assert lowlink_ok(codec)
        self.codec = codec
        self.device = torch.device(device)
        self.wire = _check_wire(wire or default_wire())
        self.pack = int(pack)
        self.chan = active_channel(codec)
        self.adapt = _FlatAdapt()  # one grayscale workflow learns once, across segments
        self._lock = threading.Lock()
        self._pend: list = []  # wire LL pieces
        self._pend_n = 0
        self._cur = _Chunk()
        self.stage_seconds = {"dispatch": 0.0, "link_fetch": 0.0}
        self.call_frames: list = []

    @property
    def calls(self) -> int:
        return len(self.call_frames)

    def submit_ll(self, llw: np.ndarray):
        """[k, hc, wc] wire LL -> ticket [(chunk, offset, n), ...].  The
        caller encodes (it keeps the encoded copy for the recentring); the
        dither pattern is per LL position, so packing never changes an
        encoding."""
        pieces = []
        with self._lock:
            if self._pend and (self._pend[0].shape[1:] != llw.shape[1:]
                               or self._pend[0].dtype != llw.dtype):
                self._flush_locked()  # size or wire change: never mixed in a chunk
            pos, k = 0, len(llw)
            while pos < k:
                take = min(self.pack - self._pend_n, k - pos)
                self._pend.append(llw[pos : pos + take])
                pieces.append((self._cur, self._pend_n, take))
                self._pend_n += take
                pos += take
                if self._pend_n == self.pack:
                    self._flush_locked()
        return pieces

    def _flush_locked(self):
        if not self._pend:
            return
        llw = self._pend[0] if len(self._pend) == 1 else np.concatenate(self._pend)
        t0 = time.perf_counter()
        n = len(llw)
        x = STAGING.upload(llw, n, self.device)
        self._cur.pending = download(list(_mark_2plane(self.codec, self.chan, x)), n)
        self.call_frames.append(n)
        self.stage_seconds["dispatch"] += time.perf_counter() - t0
        self._cur = _Chunk()
        self._pend, self._pend_n = [], 0

    def flush(self):
        """Dispatch a pending partial chunk (stream end)."""
        with self._lock:
            self._flush_locked()

    def fetch(self, pieces) -> np.ndarray:
        """Ticket -> [2, k, hc, wc] int8 (one whole-chunk wait, kept)."""
        for chunk, _, _ in pieces:
            if chunk.pending is None and chunk.planes is None:
                with self._lock:
                    # only the chunk still pending (self._cur) is flushed here;
                    # a racing submit may have flushed it meanwhile
                    if chunk.pending is None and chunk.planes is None:
                        self._flush_locked()
        out = []
        for chunk, off, n in pieces:
            with chunk.once:
                if chunk.planes is None:
                    t0 = time.perf_counter()
                    chunk.planes = chunk.pending.wait()
                    chunk.pending = None
                    self.stage_seconds["link_fetch"] += time.perf_counter() - t0
            out.append(chunk.planes[:, off : off + n])
        return out[0] if len(out) == 1 else np.concatenate(out, axis=1)


class LowLinkMarker:
    """MultiMarker-compatible variant marker over the LL transport on
    ``device``.  ``submit`` dispatches without waiting on the device;
    ``collect`` waits on the handle's own event.  With a shared ``packer``
    (PackedTwoPlane) and 3 or more variants, device calls are packed across
    markers.  ``stage_seconds`` holds the busy seconds of each host stage
    (``link_fetch``: blocked on the download in collect); ``host_batches``
    counts the batches _FlatAdapt sent to the host twin."""

    def __init__(self, codec, wms, batch_size: int = 16, packer=None, wire: str | None = None,
                 *, device):
        assert lowlink_ok(codec), "LowLinkMarker requires a single-channel DwtDctSvd codec"
        self.codec = codec
        self.device = torch.device(device)
        self.wire = _check_wire(wire or default_wire())
        self.chan = active_channel(codec)
        self.batch_size = batch_size
        self._wms_np = np.stack([np.asarray(w, np.float32).reshape(-1) for w in wms])
        self._wms = None  # device copy, placed at the first per-variant submit
        # V >= 3: the two bit-conditional planes, selected on the host; V <= 2:
        # the per-variant deltas are the same traffic or less
        self._two_plane = len(self._wms_np) >= 3
        self._packer = (packer if self.wire != "host" and self._two_plane
                        and packer is not None and packer.codec == codec else None)
        self._adapt = self._packer.adapt if self._packer is not None else _FlatAdapt()
        self._masks: dict = {}  # (hc, wc) -> [V, hc, wc] bool
        self.host_batches = 0
        self.stage_seconds = {"host_ll": 0.0, "dispatch": 0.0, "link_fetch": 0.0,
                              "recentre": 0.0, "host_qim": 0.0, "reconstruct": 0.0}

    @property
    def n_variants(self) -> int:
        return len(self._wms_np)

    def _plane_bits(self, nb: int) -> np.ndarray:
        if self._two_plane:
            return np.repeat(np.arange(2, dtype=np.float32)[:, None], nb, 1)
        return self._wms_np[:, :nb]

    def submit(self, frames: np.ndarray):
        """Dispatch one batch; returns an opaque handle for collect()."""
        k = len(frames)
        t0 = time.perf_counter()
        ll = host_ll(frames, self.chan)  # exact shape: no pad rows on either leg
        t1 = time.perf_counter()
        corr = None
        host_route = self.wire == "host"
        if self.wire == "u8" and self._adapt.use_host():
            host_route = True
            self.host_batches += 1
        if host_route:
            nb = (ll.shape[1] // self.codec.blk) * (ll.shape[2] // self.codec.blk)
            handle = (host_dll(ll, self.codec, self.chan, self._plane_bits(nb)), frames, k,
                      "host")
        else:
            llw = wire_encode(ll, self.wire, self.chan)
            corr = (ll, llw) if self.wire == "u8" else None
            if self._packer is not None:
                handle = (self._packer.submit_ll(llw), frames, k, corr)
            else:
                x = STAGING.upload(llw, k, self.device)
                if self._two_plane:
                    dll = _mark_2plane(self.codec, self.chan, x)
                else:
                    if self._wms is None:
                        self._wms = torch.as_tensor(self._wms_np, device=self.device)
                    dll = _mark(self.codec, self.chan, x, self._wms)
                handle = (download(list(dll), k), frames, k, corr)
        t2 = time.perf_counter()
        self.stage_seconds["host_ll"] += t1 - t0
        if host_route:
            self.stage_seconds["host_qim"] += t2 - t1
        elif self._packer is None:  # the packer times its own (shared) dispatches
            self.stage_seconds["dispatch"] += t2 - t1
        return handle

    def _bit_masks(self, hc: int, wc: int) -> np.ndarray:
        """[V, hc, wc] bool: each variant's block bit on the LL pixel grid
        (blocks row-major, as ops/soa.image_to_soa)."""
        key = (hc, wc)
        if key not in self._masks:
            blk = self.codec.blk
            nbh, nbw = hc // blk, wc // blk
            m = np.zeros((len(self._wms_np), hc, wc), bool)
            for v, wmv in enumerate(self._wms_np):
                bits = wmv[: nbh * nbw].reshape(nbh, nbw) > 0.5
                m[v, : nbh * blk, : nbw * blk] = np.repeat(np.repeat(bits, blk, 0), blk, 1)
            self._masks[key] = m
        return self._masks[key]

    def collect(self, handle) -> np.ndarray:
        """Handle -> [V, k, H, W, 3] uint8 marked frames."""
        got, frames, k, corr = handle
        t0 = time.perf_counter()
        host_batch = isinstance(corr, str)  # "host": the delta was computed at submit
        if host_batch:
            dll = got
        elif self._packer is not None:
            dll = self._packer.fetch(got)  # [2, k, hc, wc] int8
        else:
            dll = got.wait()  # [V or 2, k, hc, wc] int8
        t1 = time.perf_counter()
        if corr is not None and not host_batch:
            ll, llw = corr
            nb = (dll.shape[-2] // self.codec.blk) * (dll.shape[-1] // self.codec.blk)
            st: dict = {}
            dll = recentre_dll(dll, wire_error(ll, llw, self.chan), ll, self.codec.blk,
                               float(self.codec.scales[self.chan]), self._plane_bits(nb),
                               stats=st)
            self._adapt.update(st.get("repair_frac", 0.0))
            self.stage_seconds["recentre"] += time.perf_counter() - t1
        t2 = time.perf_counter()
        if self._two_plane:
            masks = self._bit_masks(*dll.shape[-2:])  # [V, hc, wc]
            dll = np.where(masks[:, None, :, :], dll[1], dll[0])
        out = reconstruct_all(frames, dll, self.chan)
        if self._packer is None:  # the packer times its own fetches (shared chunks)
            self.stage_seconds["link_fetch"] += t1 - t0
        self.stage_seconds["reconstruct"] += time.perf_counter() - t2
        return out

    def mark_all(self, frames: np.ndarray) -> np.ndarray:
        return self.collect(self.submit(frames))


class LowLinkExtractor:
    """FrameExtractor-compatible payload extractor over the LL transport on
    ``device``: the wire LL goes up, the per-frame payloads come down."""

    def __init__(self, codec, degenerator, batch_size: int = 16, wire: str | None = None,
                 *, device):
        assert lowlink_ok(codec)
        self.codec = codec
        self.device = torch.device(device)
        self.wire = _check_wire(wire or default_wire())
        self.degenerator = degenerator
        self.batch_size = batch_size
        self.chan = active_channel(codec)

    @torch.inference_mode()
    def _decode(self, llw: torch.Tensor, capacity: int) -> torch.Tensor:
        """Wire LL [k, hc, wc] on the device -> [k, payload_len] u8 payloads:
        the block grid's QIM bits (``qim_decode_soa`` on CUDA), zero-padded to
        ``capacity``, despread."""
        codec = self.codec
        ll = _wire_decode(llw, self.chan)
        nbh, nbw = ll.shape[1] // codec.blk, ll.shape[2] // codec.blk
        bits = codec._decode_ll(ll, nbh, nbw, float(codec.scales[self.chan]))
        bits = torch.nn.functional.pad(bits, (0, capacity - nbh * nbw))
        return self.degenerator.degenerate_batch(bits)

    def submit(self, frames: np.ndarray):
        """Upload and dispatch one batch, without waiting on the device."""
        k, h, w = frames.shape[:3]
        from ..wm.dwt_dct_svd import block_grid

        _, capacity = block_grid((h, w), self.codec.blk)
        ll = host_ll(frames, self.chan)
        if self.wire == "host":  # the whole decode on the host: no device call
            bits = host_extract_bits(ll, self.codec, self.chan, capacity)
            return Pending(self.degenerator.degenerate_batch_np(bits))
        x = STAGING.upload(wire_encode(ll, self.wire, self.chan), k, self.device)
        return download([self._decode(x, capacity)], k)

    def collect(self, handle) -> np.ndarray:
        out = handle.wait()
        return out if self.wire == "host" else out[0]

    def extract(self, frames: np.ndarray) -> np.ndarray:
        return self.collect(self.submit(frames))
