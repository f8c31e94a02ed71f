#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vfp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --sweep [--only PATTERN] [--package-root DIR]
                                   # only the build and the sweep of phase 5
                                   # (PATTERN: only the kernels whose name
                                   # has it; DIR: another checkout's package,
                                   # e.g. the parent commit from git archive)
    python3 chip_smoke.py --stages [--package-root DIR]
                                   # only the build and phase 5's batch stages
    python3 chip_smoke.py --sass PATTERN [--package-root DIR]
                                   # only the build and the SASS opcode counts of
                                   # the kernels whose mangled name has PATTERN
                                   # (and their I2F, I2FP, IMAD, FMUL and FADD)

Phases, each printing its lines:

1. device: the card's name and power limit (nvidia-smi); exits nonzero when
   torch sees no CUDA device — there is no CPU path;
2. build: compiles ``vfp_tpu_torch/csrc/*.cu`` with nvcc into
   ``build/vfp_tpu_torch/`` and prints the seconds;
3. kernels: each of the 22 CUDA kernels (the flagship ones' integer bodies
   in the int_path phase) against its plain PyTorch version on
   the card, at the main paths' shapes (1080p B=16, 1920x804 for the scope
   path's syntheses, [32, 1080, 1920] and [32, 4, 540, 960] for the level-1
   and q-shift analyses of [Y; U]) and at edge shapes (W=856, H=1078, N not
   a multiple of 32, flat 8x8 blocks whose texture mask divides 0/0, a black
   frame whose DT-CWT masks and delta are 0, every level of 854x480, 853x480
   and 2048x858 pyramids, an odd 33x65 grid), within the stated tolerances
   (the DT-CWT kernels, both marks, the Y mean and the DCT-QIM extract, which
   takes its means in its own read, equal; the Y mean and the extract also
   equal from one run to the next); the masks and the q-shift level also on the
   in-place halves of the detect path's level-1 output, level 1 lowpass-only
   also on the Y view of a YUV batch, in place; the SoA kernels also on the
   LL transport's 1080p blocks (the u8 wire's LL, decoded on the card);
4. main paths, each with the launch counts set to 0 and the watermark-spectrum
   cache emptied just before it, the counts read just after: the flagship codec's ``python -m vfp_tpu_torch.cli mark``
   then ``detect --payload`` on a 48-frame 1920x1080 .rawv (fused kernels),
   the same at 1918x1080 (W % 4 != 0: the SoA kernels), and a two-channel
   codec through the pipeline API (``qim_embed_soa``); then ``mark --codec
   dct`` and ``detect --codec dct`` on the 1920x1080 file (the DCT-QIM
   kernels; the Y mean once a batch, for the mark: detect's extract takes its
   own); then ``mark --codec dtcwtKey`` on a
   48-frame 1920x1080 .rawv of smooth content (the four DT-CWT mark
   kernels), then ``detect --codec dtcwtKey`` on the card (the four detect
   kernels and the masks), which must find the mark with key 0 in 48/48
   frames and with key 99 in 0/48, and agree with the plain kernel path on
   the card; then the rest of the DT-CWT: ``mark`` -> ``detect --codec
   dtcwtKey`` on a 48-frame 1920x804 scope file (the three-stage synthesis
   kernels; key 0 48/48, key 99 0/48), a float32 1080p batch through the
   codec (level 1 lowpass-only), and ``DtcwtKey(nlevels=4)`` through the
   pipeline API on 48 frames of 1280x720 plus a 4-level ``Transform2d``
   round trip of a 1080p batch (the full q-shift
   analysis and the full syntheses), each equal to the plain kernel path on
   the card; then the HLS fingerprinting workflow through the CLI
   (``hls-mark --copies 3`` of 180 1080p frames at 30 fps, three 2 s
   segments, then ``leak`` -> ``trace`` of pattern 201 with the manifests
   and of 120 blind; 36 marks, 58 extracts, PSNR > 40 dB, the first batch
   of a variant equal to the plain version, and ``MultiMarker.submit`` /
   ``collect`` with four handles in flight equal to ``mark_all``); then
   the port's HTTP service on a thread (``serve``: ``/upload`` of 180 1080p
   frames at 30 fps, 3 copies, three views and their playlists against
   ``pattern_for_view``, ``/hls``, ``/download-view``, ``/detect`` of user 1's
   segment 2 alone and twice at once; 36 marks, 4 extracts a detect, PSNR
   > 40 dB, the service's stages timed apart); then ``mark --codec dtcwtImg
   --wm-image`` -> ``detect --out-dir`` on the 48 smooth frames at 1080p and
   1920x804 (``dtcwtimg``: the first batch equal to the plain kernel path
   on the card, PSNR > 30 dB, the PNGs equal to the planes' images, the
   payload's agreement > 0.8 at 1080p); then ``durability``: ``cli
   durability`` on 180 smooth 1080p frames at 30 fps with the default codec,
   ``--codec dct`` and ``--codec dtcwtKey`` (MJPEG ``.avi`` through the
   native JPEG codec: the exit code against the report's verdict, 3 segment
   pairs, the bit codecs' and ``dtcwtKey``'s 75% bar, launches counted from
   the code, the wall split into JPEG encode, decode, file I/O and the
   card's batch calls, one frame's JPEG ms and the pinned SHA-256 of its
   q90 JPEG); then ``media``: the ffmpeg-free media layer, ``hls-mark
   --copies 3`` of an MJPEG ``.mp4`` (180 smooth 1080p frames at 30 fps,
   JPEG-coded by the port, with 6 s of synthetic audio) into ``.avi``
   segments and variants with audio sidecars (every variant verified), ``leak``
   -> ``leaked_video.mp4`` (its audio sample bytes equal to the source's) ->
   ``trace`` (the fingerprint on 100% of segments; 36 marks, 46 extracts), and
   ``mark`` -> ``detect`` of a 16-frame 1080p ``.y4m`` into a ``.y4m`` (the
   payload recovered, as the JAX CLI recovers it); the wall split into JPEG
   encode and decode, box mux, ``mark_segments``, trace and the card's batch
   calls; then ``ffmpeg``: the ffmpeg route with ``tests/ffmpeg_shim`` first
   on PATH (a fake ``ffmpeg``/``ffprobe`` over VFPRAWV1 bytes; no H.264),
   ``hls-mark --copies 3`` of the hls phase's source into 3 ``.mp4``
   segments, 9 ``.mp4`` variants (frames byte-equal to the hls phase's
   ``.rawv`` variants) and 9 ``.m4s``, ``leak`` -> ``leaked_video.mp4`` ->
   ``trace`` of 201 with the manifests (the hls phase's launches for the
   same commands), ``mark`` of a 48-frame 1080p ``.rawv`` into an
   ``.mp4`` -> ``detect`` (48/48), and ``cli durability`` of 90 1080p
   frames with 1 s segments (ffmpeg's segments, the pipe writer's marked
   ``.mp4``, ffmpeg's concat into ``full.mp4`` and its re-segmenting; 6 marks
   and 12 extracts, counted apart; the shim proves the plumbing, not
   libx264's loss); ``have_ffmpeg`` False again after it; then ``lowlink``:
   the LL-domain transport with ``VFP_LOWLINK=1`` set for the phase (the
   environment restored and ``use_lowlink`` off after it): ``cli mark`` ->
   ``detect`` of the 48-frame 1080p file on the ``u8`` and ``f16`` wires
   (48/48, PSNR > 40 dB, the share within +-1 of the full-frame file
   printed, ``qim_triplet_soa`` and ``qim_decode_soa`` once a batch, no
   fused kernel), ``hls-mark --copies 3`` of the hls phase's source on the
   ``u8`` wire (packed two-plane calls: one ``qim_triplet_soa`` each, 180
   frames in all, no batch routed to the host) -> ``leak`` 201 -> ``trace``,
   ``VFP_LL_WIRE=host`` (no launch, device memory unchanged) and the host
   clock's ``mark_all`` / ``extract`` of a 16-frame batch, full-frame
   against the wires, with the wire's stages and bytes; then ``int_path``:
   the flagship kernels' integer bodies (``int_path=True``) equal to their
   plain versions at 1080p B=16 interleaved, 1916 wide, planar, 1078 rows,
   all-0 and all-255 frames, then ``FrameMarker`` -> ``FrameExtractor``
   with ``DwtDctSvd(int_path=True)`` on the 48 smooth 1080p frames (48/48,
   PSNR > 40 dB, >= 0.98 of the bytes equal to the float32 codec's, one
   integer mark and extract a batch, no float32 body); then ``parallel``:
   the sharded steps of ``parallel/sharded.py`` on a world-1 NCCL mesh (the mark step with 3 variants of each codec equal
   to three bare ``mark_frames``, the detect step's votes [0, 16, 0] through
   an NCCL ``all_reduce``, the spatial step at W = 1920 equal to the
   unsharded mark; host ms beside the bare calls'), ``hls-mark --workers 2``
   and ``hls-mark --distributed`` as two processes at a localhost
   coordinator on the hls phase's source (the manifests and every variant's
   bytes equal to the hls phase's; the workers' 36 marks summed from what
   they return), and ``test-frame`` on a 1080p PNG (the payload back).  The
   counts must show every kernel ran and no plain version may
   see a CUDA tensor, and the watermark plane's spectrum
   (``dtcwt_level1_analysis`` on it) must run once per distinct plane: 19
   launches of that kernel over all paths;
5. timings: ms per 16-frame batch and frames/s, kernel vs plain version
   (the flagship kernels' two bodies also device-only with a cold, clean
   L2)
   (and one PyTorch library call where one computes the same function),
   with CUDA events after warm-up (``qim_triplet_soa`` and
   ``qim_decode_soa`` at the LL transport's [16, 16, 32400] blocks and
   ``qim_embed_soa`` at the 1918-wide path's [16, 16, 32265], one
   launch at a time after a 256 MB write that flushes the L2), on two clocks: host-inclusive (events
   around back-to-back wrapper calls) and device-only (the same calls
   captured in one CUDA graph and replayed), beside the bound the card's
   HBM rate and float32 peak set for the same work; the sweep: the kernels
   redesigned for Hopper (level-1 and q-shift analysis, the LeGall synthesis
   with its lowpass-only and highpass-only twins, the masks, the q-shift
   synthesis with its lowpass-only twin, the delta synthesis, the last
   timed against the chain of the three synthesis kernels it fuses, the
   level-1 u8 lowpasses of Y and of Y and U, the flagship mark (both
   bodies), level 1
   lowpass-only of f32 planes (also on the Y view of a YUV batch, beside
   the copy a contiguous-only wrapper would make), the DCT-QIM mark,
   interleaved and planar, the Y mean beside PyTorch's int64 sum of the
   same view, the DCT-QIM extract, its means taken in its own read, the
   QIM block kernels on SoA blocks and the flagship extract (both bodies),
   the callers of the triplet body) at every shape the paths give them, each equal
   to its plain version, with its
   launch geometry beside ptxas's registers and shared bytes; then one
   batch of each codec's pipeline work (and ``dtcwtKey`` at 1920x804)
   split into upload, device and download (``transfer.download``, pinned)
   on the host clock, and the
   whole ``FrameMarker.mark`` and ``MultiMarker.mark_all`` (3 variants)
   calls of a 1080p batch.

Then one JSON line per the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits nonzero.
The work files go under ``build/chip_smoke/`` and are removed at the end.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PAYLOAD = "01100101"
FULL = {"b": 16, "h": 1080, "w": 1920, "frames": 48, "narrow_w": 1918, "tail_h": 1078,
        "int_w": 1916,
        "prime_w": 856, "prime_h": 480, "scope_h": 804, "depth_h": 720, "depth_w": 1280,
        "iters": 20}
ALPHA = 20.0  # the DCT-QIM codec's default
# SHA-256 of the port's q90 JPEG of natural_frames(RandomState(14), 1, 1080, 1920)[0],
# equal to cv2.imencode's bytes (tests/test_torch_jpeg.py pins the same constant)
JPEG_1080P_Q90_SHA256 = "8b3645f4734eba2d5dfbac6afd16a62eee1022dc8c4a1d565593f512166fd15e"
# the media path: an MJPEG .mp4 of 180 smooth 1080p frames at 30 fps with 6 s of
# synthetic audio, three 2 s segments, 3 copies; then a .y4m of 16 smooth 1080p
# frames of its own seed, on which the JAX CLI's mark -> detect recovers the payload
# as the port's does (tests/test_torch_media_workflow.py runs both on these frames)
MEDIA = {"n": 180, "fps": 30, "copies": 3, "seg_frames": 60, "audio_s": 6.0, "quality": 95,
         "y4m_frames": 16, "y4m_seed": 17, "pattern": "201"}
AUDIO_RATE = 44100
REPLACES = {
    "fused_mark_planar": ("fused_embed.cu", "vfp_tpu/kernels/fused_embed.py:239"),
    "fused_extract_planar": ("fused_embed.cu", "vfp_tpu/kernels/fused_embed.py:338"),
    "qim_triplet_soa": ("qim.cu", "vfp_tpu/kernels/qim.py:186"),
    "qim_decode_soa": ("qim.cu", "vfp_tpu/kernels/qim.py:165"),
    "qim_embed_soa": ("qim.cu", "vfp_tpu/kernels/qim.py:138"),
    "fused_dct_qim_mark": ("fused_dct_qim.cu", "vfp_tpu/kernels/fused_dct_qim.py:311"),
    "fused_dct_qim_extract": ("fused_dct_qim.cu", "vfp_tpu/kernels/fused_dct_qim.py:368"),
    "y_dc_mean": ("fused_dct_qim.cu", "vfp_tpu/kernels/fused_dct_qim.py:297"),
    # each with its chained twin (:918, dtcwt_masks.py:227): one kernel covers both
    "dtcwt_level1_ll_y": ("dtcwt_level1.cu", "vfp_tpu/kernels/dtcwt_level1.py:508"),
    "dtcwt_qshift_masks": ("dtcwt_masks.cu", "vfp_tpu/kernels/dtcwt_masks.py:190"),
    "dtcwt_delta_synthesis": ("dtcwt_delta.cu", "vfp_tpu/kernels/dtcwt_delta.py:258"),
    "dtcwt_level1_analysis": ("dtcwt_level1.cu", "vfp_tpu/kernels/dtcwt_level1.py:276"),
    # the detect path, each with its chained twin (dtcwt_level1.py:888
    # dtcwt_level1_ll_color_chain, :947 dtcwt_qshift_ll_chain, :972
    # dtcwt_qshift_hp_chain): one kernel covers both
    "dtcwt_level1_ll_color": ("dtcwt_level1.cu", "vfp_tpu/kernels/dtcwt_level1.py:428"),
    "dtcwt_qshift_ll": ("dtcwt_qshift.cu", "vfp_tpu/kernels/dtcwt_level1.py:685"),
    "dtcwt_qshift_hp": ("dtcwt_qshift.cu", "vfp_tpu/kernels/dtcwt_level1.py:797"),
    "dtcwt_legall_synthesis_hp": ("dtcwt_synthesis.cu", "vfp_tpu/kernels/dtcwt_synthesis.py:467"),
    # the rest of the transform: frames off the fused geometry, float frames, any depth
    "dtcwt_level1_analysis_ll": ("dtcwt_level1.cu", "vfp_tpu/kernels/dtcwt_level1.py:347"),
    "dtcwt_qshift_analysis": ("dtcwt_qshift.cu", "vfp_tpu/kernels/dtcwt_level1.py:715"),
    "dtcwt_qshift_synthesis": ("dtcwt_synthesis.cu", "vfp_tpu/kernels/dtcwt_synthesis.py:273"),
    "dtcwt_qshift_synthesis_ll": ("dtcwt_synthesis.cu", "vfp_tpu/kernels/dtcwt_synthesis.py:497"),
    "dtcwt_legall_synthesis": ("dtcwt_synthesis.cu", "vfp_tpu/kernels/dtcwt_synthesis.py:299"),
    "dtcwt_legall_synthesis_ll": ("dtcwt_synthesis.cu", "vfp_tpu/kernels/dtcwt_synthesis.py:523"),
    # the flagship Pallas functions' second body, under the static int_path
    # (fused_embed.py:127-226 and :304-334): the same wrappers with int_path=True
    "fused_mark_planar.int": ("fused_embed.cu", "vfp_tpu/kernels/fused_embed.py:239"),
    "fused_extract_planar.int": ("fused_embed.cu", "vfp_tpu/kernels/fused_embed.py:338"),
}
DTCWT = ("dtcwt_level1_ll_y", "dtcwt_qshift_masks", "dtcwt_delta_synthesis",
         "dtcwt_level1_analysis")
DTCWT_DETECT = ("dtcwt_level1_ll_color", "dtcwt_qshift_ll", "dtcwt_qshift_hp",
                "dtcwt_qshift_masks", "dtcwt_legall_synthesis_hp")
# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, at 700 W):
# HBM bytes/s and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float32 operations per unit of work, counted from each kernel's source (a
# multiply, an add, a compare or clamp, a division and a rounding count one
# each): per 8x8 tile for the fused kernels, per 4x4 block for the SoA
# kernels, per pixel for the Y mean.
FLOPS_PER_UNIT = {
    # lincomb 64 px x 5 + LL 16 x 7 + triplet 770 + QIM 5 + delta 48 + epilogue 64 x 2 x 5
    "fused_mark_planar": 1895,
    "fused_extract_planar": 1205,  # lincomb + LL + triplet + bit
    # the integer bodies (int32 operations counted at the float32 rate): LL 16 x
    # 11 (2 conversions and 2 scalings more), du 16 x 5 (1024 x and the rounding
    # more), epilogue 64 x 2 x 6 (shift, multiply, 2 adds, shift, 2-sided clamp)
    "fused_mark_planar.int": 2119,
    "fused_extract_planar.int": 1269,
    # the triplet counted in its 16-entry form (the algorithm's work); the
    # kernels keep the symmetric matrices as 10 entries and do 246 fewer
    "qim_triplet_soa": 770,  # Gram 112, 5 normalisations and 4 4x4 squarings, v, s0, u
    "qim_decode_soa": 773,
    "qim_embed_soa": 825,  # triplet + QIM + 16-entry rank-1 update
    # Y and U lincombs 64 x (5 + 6) (Y's zero offset left out), row pass 64 x 14
    # + 8 x 15, column pass 64 x 14 (row 4 of D reuses row 0's products), v 15,
    # masks 167, QIM 10, epilogue 64 x 11
    "fused_dct_qim_mark": 3512,
    "fused_dct_qim_extract": 2811,
    "y_dc_mean": 6,  # lincomb 5 + one float64 add
    # DT-CWT, each intermediate counted once: per level-1 position (4 planes) Y
    # lincombs 4 x 6, row pass 2 x 2 x 9, column pass 4 x 9
    "dtcwt_level1_ll_y": 96,
    # per level-1 position (16 planes): rows 2 x 2 x (9 + 5), columns 4 x 28
    "dtcwt_level1_analysis": 168,
    # per mask output (6 bands): q-shift rows 8 x 4 x 54, columns 4 x 4 x 81,
    # magnitudes 4 x 42, mean filter 4 x 24, rebin 24, divide and ceil 12
    "dtcwt_qshift_masks": 3324,
    # per output pixel: 4 trees x (40/32 + 27/16 + 13/8 + 13/4 + 2/2 + 2) + 4
    "dtcwt_delta_synthesis": 47,
    # per level-1 position (8 planes): ll_y's 96 for each of Y and U
    "dtcwt_level1_ll_color": 192,
    # per output position, 4 trees x (row pass 2 x 27 + column pass 27)
    "dtcwt_qshift_ll": 324,
    # per output position, 4 trees x (row passes 2 x 2 x 27 + column passes 3 x 27)
    "dtcwt_qshift_hp": 756,
    # per output pixel: 4 trees x (columns (lo 4 + hi 7) / 2 + rows 7) + 3 adds + 1 multiply
    "dtcwt_legall_synthesis_hp": 54,
    # per level-1 position (4 planes): rows 2 x 2 x 9, columns 4 x 9
    "dtcwt_level1_analysis_ll": 72,
    # per output position, 4 trees x (row passes 2 x 2 x 27 + column passes 4 x 27)
    "dtcwt_qshift_analysis": 864,
    # per output sample, 7 of the 14 taps hitting: rows 2 x 13 + 1, columns (lo 27 + hi 27) / 2
    "dtcwt_qshift_synthesis": 54,
    "dtcwt_qshift_synthesis_ll": 19.5,  # rows 13, columns 13 / 2
    # per output pixel: 4 trees x (columns (lo 7 + hi 7) / 2 + rows 7) + 3 adds + 1 multiply
    "dtcwt_legall_synthesis": 60,
    "dtcwt_legall_synthesis_ll": 16,  # 4 trees x (columns 2 / 2 + rows 2) + 4
}


def natural_frames(rng, b, h, w):
    """Smooth numpy content: coarse noise upsampled 8x plus mild grain."""
    small = rng.rand(b, -(-h // 8), -(-w // 8), 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)[:, :h, :w] * 220
    return np.clip(f + rng.rand(b, h, w, 3) * 20, 0, 255).astype(np.uint8)


def smooth_frames(rng, b, h, w):
    """Natural-like frames without cv2: coarse noise upsampled bilinearly 16x
    plus mild grain, the compressible content the DT-CWT key codec is
    specified on (its JAX test marks blurred noise at > 35 dB)."""
    small = torch.as_tensor(rng.rand(b, 3, h // 16 + 2, w // 16 + 2).astype(np.float32))
    f = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                        align_corners=False).permute(0, 2, 3, 1).numpy()
    return np.clip(f * 235 + rng.rand(b, h, w, 3) * 12, 0, 255).astype(np.uint8)


def ptxas_report(log: str) -> dict:
    """{'<source> <kernel><template arguments>': {registers, spill, stack,
    smem}} per kernel, from the build's ``-Xptxas=-v`` report (bytes)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            src = re.search(r"_\d+_(\w+?)_cu_", mangled)
            fn = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            end = fn.end() + int(fn.group(1)) if fn else 0
            name = f"{src.group(1) if src else '?'}.cu {mangled[fn.end():end] if fn else mangled}"
            targs = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end:])
            if targs:  # bool and int template arguments, e.g. ILb1ELi2EE -> <1, 2>
                name += f"<{', '.join(re.findall(r'L[a-z](\d+)E', targs.group(1)))}>"
            spill = stack = 0
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            stack = int(re.search(r"(\d+) bytes stack frame", line).group(1))
        elif name and "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = {"registers": int(re.search(r"Used (\d+) registers", line).group(1)),
                         "spill": spill, "stack": stack, "smem": int(smem.group(1)) if smem else 0}
            name = None
    return out


def ptxas_summary(log: str) -> list[str]:
    """'<source> <kernel><template arguments>: N registers, S bytes spilled'
    per kernel."""
    return [f"{name}: {r['registers']} registers, {r['spill']} bytes spilled, {r['stack']} bytes "
            f"stack, {r['smem']} bytes shared" for name, r in ptxas_report(log).items()
            ] or ["report not available (library loaded from disk)"]


# The launch geometry of the kernels redesigned for Hopper, as their
# launchers in csrc/ set it: f(input tensor) -> (ptxas name, blocks,
# threads, dynamic shared bytes).
def _level1_geometry(x):
    b, h, w = x.shape
    tiles8 = b * -(-(h // 2) // 8) * -(-(w // 2) // 32)
    th = 8 if tiles8 >= 2 * 132 else 2
    return (f"dtcwt_level1.cu analysis_tile_kernel<{th}>", b * -(-(h // 2) // th) * -(-(w // 2) // 32),
            256 if th == 8 else 96, 0)


def _qshift_geometry(x):
    b, _, h, w = x.shape
    return ("dtcwt_qshift.cu qshift_kernel<2>", 4 * b * -(-(h // 2) // 16) * -(-(w // 2) // 32),
            160, 0)


def _legall_geometry(mode, bands):
    """legall_kernel<mode, 0> (LEGALL_ROLL is odd): a 32 x 64 output tile;
    its 19 x 35 input window of 4 x ``bands`` planes and the lo (and hi)
    rows in dynamic shared memory."""
    def geometry(x):
        b, _, h, w = x.shape
        smem = 4 * (4 * bands * 19 * 35 + (1 if bands == 1 else 2) * 19 * 64)
        return (f"dtcwt_synthesis.cu legall_kernel<{mode}, 0>",
                b * -(-(2 * h) // 32) * -(-(2 * w) // 64), 256, smem)
    return geometry


def _qshift_synthesis_geometry(full):
    """qshift_kernel<full, 1> (both q-shift rolls are odd): a 32 x 64 output
    tile of one (frame, tree); its 23 x 39 input window of 4 planes or 1 (rows
    of 40 floats) and lo (and hi) at 23 x 64 in dynamic shared memory."""
    def geometry(x):
        b, _, h, w = x.shape
        bands = 4 if full else 1
        smem = 4 * (bands * 23 * 40 + (2 if full else 1) * 23 * 64)
        return (f"dtcwt_synthesis.cu qshift_kernel<{int(full)}, 1>",
                4 * b * -(-(2 * h) // 32) * -(-(2 * w) // 64), 256, smem)
    return geometry


def _delta_geometry(x):
    """delta_kernel<1> (the LeGall roll is odd): a 64 x 128 pixel tile; its
    static shared memory (the 4 trees' 19 x 28 level-3 windows and two stage
    buffers) is in ptxas's report."""
    b, _, h3, w3 = x.shape
    return ("dtcwt_delta.cu delta_kernel<1>", b * -(-(8 * h3) // 64) * -(-(8 * w3) // 128), 256, 0)


def _masks_geometry(x):
    """an 8 x 24 tile of mask outputs; the row-pass values of its 17 x 116
    window (4 trees, lo and hi, 120 floats a row) in dynamic shared memory"""
    b, _, h1, w1 = x.shape
    return ("dtcwt_masks.cu masks_kernel", b * -(-(h1 // 4) // 8) * -(-(w1 // 4) // 24), 256,
            4 * 2 * 17 * 120 * 4)


def _ll_tile_geometry(ch):
    """ll_tile_kernel<ch, words>: an 8 x 32 tile of level-1 positions, two
    positions a thread; word loads where W % 4 == 0 (the batch's base is
    aligned)."""
    def geometry(x):
        b, h, w, _ = x.shape
        return (f"dtcwt_level1.cu ll_tile_kernel<{ch}, {int(w % 4 == 0)}>",
                b * -(-(h // 2) // 8) * -(-(w // 2) // 32), 128, 0)
    return geometry


def _mark_geometry(int_path):
    """mark_tile_kernel<vec, int_path> on the interleaved view: 8 tile rows x
    16 tiles a block, one thread per tile; 16-byte staging where W % 16 ==
    0, else 4-byte."""
    def geometry(x):
        b, _, h, w = x.shape
        tiles_h, tiles_w = -(-h // 8), -(-w // 8)
        return (f"fused_embed.cu mark_tile_kernel<{16 if w % 16 == 0 else 4}, {int(int_path)}>",
                b * -(-tiles_h // 8) * -(-tiles_w // 16), 128, 0)
    return geometry


def _ll_f32_geometry(x):
    """ll_f32_tile_kernel<load>: an 8 x 32 tile of level-1 positions, two
    positions a thread; load 2 (16-byte cp.async) for unit column stride,
    W % 4 == 0 and 16-byte aligned rows, 1 (scalar, one wrap a run) for
    other W % 4 == 0 layouts, 0 (each column wrapped) for W % 4 == 2."""
    b, h, w = x.shape
    sb, sh, sw = x.stride()
    aligned = sw == 1 and sh % 4 == 0 and sb % 4 == 0 and x.data_ptr() % 16 == 0
    load = 2 if w % 4 == 0 and aligned else 1 if w % 4 == 0 else 0
    return (f"dtcwt_level1.cu ll_f32_tile_kernel<{load}>",
            b * -(-(h // 2) // 8) * -(-(w // 2) // 32), 128, 0)


def _interleaved(x, n) -> bool:
    """u8 planes [B, 3, H, W] that are the view of an interleaved batch whose
    start, rows and batch items are n-byte aligned (fused_dct_qim.cu)."""
    sb, sc, sh, sw = x.stride()
    return sc == 1 and sw == 3 and all(v % n == 0 for v in (x.data_ptr(), sh, sb))


def _planar(x, n) -> bool:
    """Channel planes of unit pixel stride, n-byte aligned."""
    sb, sc, sh, sw = x.stride()
    return sw == 1 and all(v % n == 0 for v in (x.data_ptr(), sc, sh, sb))


def _dct_mark_geometry(x):
    """mark_tile_kernel<vec> of the DCT-QIM mark: 4 tile rows x 16 tiles a
    block, 128 threads; 16- or 8-byte staging on the aligned interleaved
    view, 0 (8-pixel runs of each channel) on aligned channel planes, 1
    (bytes through the strides) for any other layout."""
    b, _, h, w = x.shape
    vec = (16 if w % 16 == 0 and _interleaved(x, 16) else 8 if _interleaved(x, 8)
           else 0 if _planar(x, 8) else 1)
    return (f"fused_dct_qim.cu mark_tile_kernel<{vec}>",
            b * -(-(h // 8) // 4) * -(-(w // 8) // 16), 128, 0)


def _y_mean_geometry(x):
    """y_mean_kernel<layout>: 8 pixel rows a block, a warp each; 16 / 8: the
    interleaved view by 16- / 8-byte loads, 1: bytes through the strides."""
    b, _, h, w = x.shape
    layout = 16 if w // 8 * 8 % 16 == 0 and _interleaved(x, 16) else 8 if _interleaved(x, 8) else 1
    return (f"fused_dct_qim.cu y_mean_kernel<{layout}>", b * max(1, -(-(h // 8 * 8) // 8)), 256, 0)


def _dct_extract_geometry(x):
    """extract_kernel<layout>, the extract's first launch: a tile a thread,
    128 a block; 8: the interleaved view by 8-byte loads, 1: bytes through
    the strides."""
    b, _, h, w = x.shape
    return (f"fused_dct_qim.cu extract_kernel<{8 if _interleaved(x, 8) else 1}>",
            b * -(-(h // 8) * (w // 8) // 128), 128, 0)


def _soa_geometry(kernel):
    """The QIM kernels on [B, 16, N] blocks: a thread a block, 128 a block
    of threads."""
    def geometry(x):
        return (f"qim.cu {kernel}", -(-x.shape[0] * x.shape[2] // 128), 128, 0)
    return geometry


def _extract_geometry(int_path):
    """extract_kernel<int_path>: one thread per 8x8 tile, 128 a block."""
    def geometry(x):
        b, _, h, w = x.shape
        return (f"fused_embed.cu extract_kernel<{int(int_path)}>",
                -(-b * (h // 8) * (w // 8) // 128), 128, 0)
    return geometry


GEOMETRY = {"dtcwt_level1_analysis": _level1_geometry, "dtcwt_qshift_analysis": _qshift_geometry,
            "dtcwt_level1_ll_y": _ll_tile_geometry(1), "dtcwt_level1_ll_color": _ll_tile_geometry(2),
            "fused_mark_planar": _mark_geometry(False), "fused_mark_planar.int": _mark_geometry(True),
            "dtcwt_legall_synthesis": _legall_geometry(0, 4),
            "dtcwt_legall_synthesis_ll": _legall_geometry(1, 1),
            "dtcwt_legall_synthesis_hp": _legall_geometry(2, 3),
            "dtcwt_qshift_masks": _masks_geometry,
            "dtcwt_qshift_synthesis": _qshift_synthesis_geometry(True),
            "dtcwt_qshift_synthesis_ll": _qshift_synthesis_geometry(False),
            "dtcwt_delta_synthesis": _delta_geometry,
            "dtcwt_level1_analysis_ll": _ll_f32_geometry, "fused_dct_qim_mark": _dct_mark_geometry,
            "y_dc_mean": _y_mean_geometry, "fused_dct_qim_extract": _dct_extract_geometry,
            "qim_decode_soa": _soa_geometry("decode_kernel"),
            "qim_triplet_soa": _soa_geometry("triplet_kernel"),
            "qim_embed_soa": _soa_geometry("embed_kernel"),
            "fused_extract_planar": _extract_geometry(False),
            "fused_extract_planar.int": _extract_geometry(True)}


def occupancy_line(name, x, report) -> str:
    """Blocks, threads, shared bytes, registers and spills of one launch,
    and the blocks one H100 SM can hold at once (2048 threads, 32 blocks,
    65,536 registers allocated per warp in units of 256, 233,472 bytes of
    shared memory with 1 KB reserved per block)."""
    kernel, blocks, threads, dynamic = GEOMETRY[name](x)
    shape = list(x.shape)
    r = report.get(kernel)
    if r is None:
        return f"occupancy {name} @ {tuple(shape)}: {blocks} blocks x {threads} threads " \
               f"({kernel}: no ptxas report)"
    warps = -(-threads // 32)
    per_warp = -(-r["registers"] * 32 // 256) * 256
    smem = r["smem"] + dynamic
    resident = min(32, 64 // warps, 65536 // per_warp // warps, 233472 // (smem + 1024))
    return (f"occupancy {name} @ {tuple(shape)}: {kernel}, {blocks} blocks x {threads} threads, "
            f"{smem} bytes shared, {r['registers']} registers, {r['spill']} bytes spilled, "
            f"{r['stack']} bytes stack; at most {resident} blocks ({resident * warps} warps) "
            f"resident per SM, {blocks / (132 * resident):.2f} waves on 132 SMs")


# the opcodes that tell the flagship kernels' two bodies apart: conversions
# (I2F by the conversion unit, I2FP on Hopper's float pipe), integer
# multiply-adds, float multiplies and adds
SASS_KEY_OPS = ("I2F", "I2FP", "IMAD", "FMUL", "FADD")


def sass_report(lib: Path, pattern: str) -> list[str]:
    """For each kernel of ``lib`` whose mangled name contains ``pattern``:
    its static SASS instruction count, the count between consecutive
    barriers (a tiled kernel's stages; loops count once) and its opcode
    histogram, from ``cuobjdump -sass`` of the CUDA toolkit."""
    from vfp_tpu_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    lines = []
    for fn in re.split(r"\n\s*Function : ", dump)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if pattern not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)
        stages, n = [], 0
        for op in ops:
            n += 1
            if op.startswith("BAR."):
                stages.append(n)
                n = 0
        hist = collections.Counter(op.split(".")[0] for op in ops)
        lines.append(f"sass {name}: {len(ops)} instructions; between barriers "
                     f"{stages + [n]}; " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
        lines.append(f"sass counts {name}: " + ", ".join(
            f"{k} {hist[k]}" for k in SASS_KEY_OPS))
    return lines or [f"sass: no kernel matches {pattern!r}"]


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def spread_wm(codec, h, w, device):
    from vfp_tpu_torch.wm import Shuffler

    wm = Shuffler(key=0).generate_wm(np.array([int(c) for c in PAYLOAD]),
                                     codec.wm_capacity((h, w, 3)))
    return torch.as_tensor(np.asarray(wm, np.float32).reshape(-1), device=device)


def assert_payload(bits, capacity):
    """Decoded [B, nbh*nbw] bits despread to PAYLOAD in every frame."""
    from vfp_tpu_torch.wm import DeShuffler

    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    got = deg.degenerate_batch(torch.nn.functional.pad(bits, (0, capacity - bits.shape[1])))
    want = torch.tensor([int(c) for c in PAYLOAD], dtype=torch.uint8, device=bits.device)
    assert bool((got == want).all()), f"payload not recovered: {got.tolist()}"


# -- phase 3: each kernel against its plain version -----------------------------

def _frac_equal(a, b) -> float:
    return float((a == b).float().mean())


def check_kernels(device, cfg) -> dict:
    """Kernel vs plain version at every shape; returns max abs error per kernel."""
    from vfp_tpu_torch.kernels import fused_embed as fe
    from vfp_tpu_torch.kernels import qim
    from vfp_tpu_torch.wm import DwtDctSvd, block_grid

    rng = np.random.RandomState(0)
    codec = DwtDctSvd()
    err = {name: 0.0 for name in REPLACES}

    def record(name, value):
        err[name] = max(err[name], float(value))

    fused_shapes = [(cfg["b"], cfg["h"], cfg["w"]), (2, cfg["prime_h"], cfg["prime_w"]),
                    (2, cfg["tail_h"], cfg["w"])]
    for b, h, w in fused_shapes:
        frames = torch.as_tensor(natural_frames(rng, b, h, w), device=device)
        planes = frames.permute(0, 3, 1, 2)
        (nbh, nbw), _ = block_grid((h, w))
        wm2d = spread_wm(codec, h, w, device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
        got = fe.fused_mark_planar(planes, wm2d, 15.0, 1)
        torch.cuda.synchronize()
        want = fe.fused_mark_planar_reference(planes, wm2d, 15.0, 1)
        same = _frac_equal(got, want)
        record("fused_mark_planar", (got.int() - want.int()).abs().max())
        assert torch.equal(got, want), f"fused_mark_planar {b}x{h}x{w}: {same:.5f} identical"
        assert torch.equal(got[:, :, 8 * nbh:], planes[:, :, 8 * nbh:]), "tail rows modified"
        bits = fe.fused_extract_planar(got, 15.0, 1)
        torch.cuda.synchronize()
        want_bits = fe.fused_extract_planar_reference(got, 15.0, 1)
        record("fused_extract_planar", (bits - want_bits).abs().max())
        assert torch.equal(bits, want_bits), f"fused_extract_planar {b}x{h}x{w}"
        assert_payload(bits.reshape(b, -1), codec.wm_capacity((h, w, 3))[1])
        print(f"kernels: fused mark/extract {b}x{h}x{w}: {same:.6f} of pixels identical, "
              f"{_frac_equal(bits, want_bits):.6f} of bits identical")

    soa_inputs = [path_soa(codec, torch.as_tensor(natural_frames(rng, b, h, w), device=device))
                  for b, h, w in [(cfg["b"], cfg["h"], cfg["narrow_w"]),
                                  (cfg["b"], cfg["h"], cfg["w"])]]
    # the LL transport's blocks: the u8 wire's 1080p LL, decoded on the card
    soa_inputs.append(lowlink_soa(natural_frames(rng, cfg["b"], cfg["h"], cfg["w"]), device))
    soa_inputs.append(torch.as_tensor(rng.rand(2, 16, 700).astype(np.float32) * 300,
                                      device=device))
    for m in soa_inputs:  # each output equal to the plain version's
        n = m.shape[2]
        got = qim.qim_triplet_soa(m)
        torch.cuda.synchronize()
        for g, w in zip(got, qim.qim_triplet_soa_reference(m)):
            record("qim_triplet_soa", (g - w).abs().max())
            assert torch.equal(g, w), f"qim_triplet_soa N={n}"

        bits = qim.qim_decode_soa(m, 15.0)
        torch.cuda.synchronize()
        want_bits = qim.qim_decode_soa_reference(m, 15.0)
        record("qim_decode_soa", (bits - want_bits).abs().max())
        assert torch.equal(bits, want_bits), f"qim_decode_soa N={n}"

        wm = torch.as_tensor(rng.randint(0, 2, n).astype(np.float32), device=device)
        marked = qim.qim_embed_soa(m, wm, 15.0)
        torch.cuda.synchronize()
        want = qim.qim_embed_soa_reference(m, wm, 15.0)
        record("qim_embed_soa", (marked - want).abs().max())
        assert torch.equal(marked, want), f"qim_embed_soa N={n}"
        print(f"kernels: SoA triplet/decode/embed {tuple(m.shape)}: equal to the plain versions")
    check_dct_kernels(device, cfg, rng, record)
    check_dtcwt_kernels(device, cfg, rng, record)
    check_full_dtcwt_kernels(device, cfg, rng, record)
    return err


def _with_flat_blocks(frames):
    """Black, white and mid-grey 8x8-aligned fields: their texture-mask
    divisions are 0/0 and x/0, and IEEE comparisons decide the branches."""
    frames[:, 0:200] = 0
    frames[:, 200:400] = 255
    frames[:, 400:600, : frames.shape[2] // 2] = 128
    return frames


def check_dct_kernels(device, cfg, rng, record):
    """The DCT-QIM kernels and the Y mean against their plain versions, all
    equal; the mark gets the same means as its plain version, the extract
    (the codec's call) takes each frame's mean in its own read.  The Y mean
    and the extract are run twice: their atomics and partial sums may land
    in any order, the results may not move."""
    from vfp_tpu_torch.kernels import fused_dct_qim as dq

    shapes = [(cfg["b"], cfg["h"], cfg["w"], False), (2, cfg["prime_h"], cfg["prime_w"], False),
              (2, cfg["h"], cfg["w"], True)]
    for b, h, w, flat in shapes:
        frames = natural_frames(rng, b, h, w)
        frames = torch.as_tensor(_with_flat_blocks(frames) if flat else frames, device=device)
        views = [frames.permute(0, 3, 1, 2)]
        if b == 2 and not flat:
            views.append(views[0].contiguous())  # the kernels' strided (not interleaved) path
        for planes in views:
            means = dq.y_dc_mean(planes)
            torch.cuda.synchronize()
            want_means = dq.y_dc_mean_reference(planes)
            record("y_dc_mean", (means - want_means).abs().max())
            assert torch.equal(means, want_means), (means, want_means)
            assert torch.equal(dq.y_dc_mean(planes), means), "y_dc_mean moved between runs"
            wm2d = torch.as_tensor(rng.randint(0, 2, (h // 8, w // 8)).astype(np.float32),
                                   device=device)
            got = dq.fused_dct_qim_mark(planes, wm2d, ALPHA, means)
            torch.cuda.synchronize()
            want = dq.fused_dct_qim_mark_reference(planes, wm2d, ALPHA, means)
            same = _frac_equal(got, want)
            record("fused_dct_qim_mark", (got.int() - want.int()).abs().max())
            assert torch.equal(got, want), f"fused_dct_qim_mark {b}x{h}x{w}: {same:.6f} identical"
            assert got.stride() == planes.stride()
            bits = dq.fused_dct_qim_extract(got, ALPHA)
            torch.cuda.synchronize()
            want_bits = dq.fused_dct_qim_extract_reference(got, ALPHA)
            record("fused_dct_qim_extract", (bits - want_bits).abs().max())
            assert torch.equal(bits, want_bits), f"fused_dct_qim_extract {b}x{h}x{w}"
            assert torch.equal(dq.fused_dct_qim_extract(got, ALPHA), bits), "extract moved"
            if not flat:  # a flat field clips at 0 and 255 and cannot carry every bit
                assert _frac_equal(bits, wm2d.expand_as(bits)) >= 0.999, "bits not embedded"
            print(f"kernels: DCT-QIM mark/extract {b}x{h}x{w}{' flat' if flat else ''} "
                  f"{'interleaved' if planes.stride(1) == 1 else 'planar'}: {same:.6f} of "
                  f"pixels identical, bits and means equal")


def key_wm(codec, h, w, device, key=0):
    from vfp_tpu_torch.wm import CorrShuffler

    return torch.as_tensor(CorrShuffler(key).generate_wm(None, codec.wm_capacity((h, w, 3))),
                           device=device)


def check_dtcwt_kernels(device, cfg, rng, record):
    """The four DT-CWT kernels against their plain versions, each fed the
    same input: the level-1 Y lowpasses, the masks (which must be equal:
    ceil turns a last-bit difference into a whole step), the delta synthesis
    on the codec's own delta planes, and the watermark plane's spectrum."""
    from vfp_tpu_torch.kernels import dtcwt_delta as dd, dtcwt_level1 as dl, dtcwt_masks as dm
    from vfp_tpu_torch.wm import DtcwtKey

    codec = DtcwtKey()
    shapes = [(cfg["b"], cfg["h"], cfg["w"], False), (2, cfg["prime_h"], cfg["prime_w"], False),
              (2, cfg["h"], cfg["w"], True)]
    for b, h, w, flat in shapes:
        frames = natural_frames(rng, b, h, w)
        if flat:  # frame 0 black (masks and delta exactly 0), frame 1 flat fields
            frames[0] = 0
            frames[1:] = _with_flat_blocks(frames[1:])
        frames = torch.as_tensor(frames, device=device)
        ll = dl.dtcwt_level1_ll_y(frames)
        torch.cuda.synchronize()
        want_ll = dl.dtcwt_level1_ll_y_reference(frames)
        record("dtcwt_level1_ll_y", (ll - want_ll).abs().max())
        assert torch.equal(ll, want_ll), "dtcwt_level1_ll_y"
        masks = dm.dtcwt_qshift_masks(ll, codec.step)
        torch.cuda.synchronize()
        want_masks = dm.dtcwt_qshift_masks_reference(ll, codec.step)
        same_masks = _frac_equal(masks, want_masks)
        record("dtcwt_qshift_masks", (masks - want_masks).abs().max())
        assert same_masks >= 0.9999, f"dtcwt_qshift_masks {b}x{h}x{w}: {same_masks:.6f} equal"
        dsubs = codec._delta_subs(masks, codec.wm_highpass(key_wm(codec, h, w, device)))
        du = dd.dtcwt_delta_synthesis(dsubs)
        torch.cuda.synchronize()
        want_du = dd.dtcwt_delta_synthesis_reference(dsubs)
        record("dtcwt_delta_synthesis", (du - want_du).abs().max())
        assert torch.equal(du, want_du), "dtcwt_delta_synthesis"
        if flat:
            assert not masks[0].any() and not du[0].any(), "black frame: masks and delta not 0"
        print(f"kernels: DT-CWT level-1/masks/delta {b}x{h}x{w}{' flat' if flat else ''}: "
              f"lowpass max err {float((ll - want_ll).abs().max()):.3g}, {same_masks:.6f} of "
              f"masks equal (max {float(masks.max()):.0f}), delta max err "
              f"{float((du - want_du).abs().max()):.3g}")
        check_dtcwt_detect_kernels(codec, frames, ll, masks, record, f"{b}x{h}x{w}"
                                   + (" flat" if flat else ""))
    wm_plane = key_wm(codec, cfg["h"], cfg["w"], device).reshape(1, *codec.wm_capacity(
        (cfg["h"], cfg["w"], 3)))
    for x in (wm_plane, torch.as_tensor(rng.rand(2, cfg["prime_h"], cfg["prime_w"]).astype(
            np.float32) * 255, device=device)):
        got = dl.dtcwt_level1_analysis(x)
        torch.cuda.synchronize()
        want = dl.dtcwt_level1_analysis_reference(x)
        record("dtcwt_level1_analysis", (got - want).abs().max())
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-4), "dtcwt_level1_analysis"
        print(f"kernels: DT-CWT level-1 analysis {tuple(x.shape)}: max err "
              f"{float((got - want).abs().max()):.3g}")


def check_dtcwt_detect_kernels(codec, frames, ll_y, masks_y, record, label):
    """The detect kernels against their plain versions on the same input:
    the Y and U lowpasses, the U q-shift levels 2 (lowpasses) and 3
    (highpasses) on the in-place U half, the masks on the in-place Y half
    (equal to those of the mark path's contiguous Y lowpasses), and the
    synthesis on the codec's own folded planes."""
    from vfp_tpu_torch.kernels import dtcwt_level1 as dl, dtcwt_masks as dm
    from vfp_tpu_torch.kernels import dtcwt_synthesis as ds

    ll = dl.dtcwt_level1_ll_color(frames)
    torch.cuda.synchronize()
    want = dl.dtcwt_level1_ll_color_reference(frames)
    record("dtcwt_level1_ll_color", (ll - want).abs().max())
    assert torch.equal(ll, want), "dtcwt_level1_ll_color"
    assert torch.equal(ll[:, 0], ll_y), "the Y half differs from dtcwt_level1_ll_y"
    masks = dm.dtcwt_qshift_masks(ll[:, 0], codec.step)  # the strided view, in place
    torch.cuda.synchronize()
    assert torch.equal(masks, masks_y), "masks of the strided Y half differ"
    errs = {}
    u_ll2 = dl.dtcwt_qshift_ll(ll[:, 1])
    torch.cuda.synchronize()
    errs["dtcwt_qshift_ll"] = (u_ll2 - dl.dtcwt_qshift_ll_reference(ll[:, 1])).abs().max()
    assert torch.equal(u_ll2, dl.dtcwt_qshift_ll(ll[:, 1].contiguous())), "strided U half"
    u_hp3 = dl.dtcwt_qshift_hp(u_ll2)
    torch.cuda.synchronize()
    errs["dtcwt_qshift_hp"] = (u_hp3 - dl.dtcwt_qshift_hp_reference(u_ll2)).abs().max()
    folded = codec._decode_coeffs(u_hp3, masks, lambda subs: subs)  # the synthesis input
    planes = ds.dtcwt_legall_synthesis_hp(folded)
    torch.cuda.synchronize()
    errs["dtcwt_legall_synthesis_hp"] = (
        planes - ds.dtcwt_legall_synthesis_hp_reference(folded)).abs().max()
    for name, e in errs.items():
        record(name, e)
        assert float(e) <= 1e-5, f"{name} {label}: max err {float(e)}"
    print(f"kernels: DT-CWT detect {label}: Y/U lowpass max err "
          f"{float((ll - want).abs().max()):.3g}, strided-Y masks equal, "
          + ", ".join(f"{k[6:]} max err {float(v):.3g}" for k, v in errs.items()))


def compare_plain(name, x, record, label):
    """One DT-CWT wrapper against its plain version on the same card input:
    they must be equal.  Returns the kernel's output."""
    from vfp_tpu_torch.kernels import dtcwt_level1 as dl, dtcwt_synthesis as ds

    module = dl if hasattr(dl, name) else ds
    got = getattr(module, name)(x)
    torch.cuda.synchronize()
    want = getattr(module, name + "_reference")(x)
    err = float((got - want).abs().max())
    record(name, err)
    assert got.shape == want.shape and torch.equal(got, want), f"{name} {label}: max err {err}"
    return got


def scope_delta_stages(device, cfg, rng):
    """The inputs of path 1's three synthesis stages, from the mark glue on 16
    smooth 1920x804 frames: the level-3 delta planes [16, 16, 101, 240], the
    cropped level-2 lowpasses [16, 4, 201, 480] and the level-1 lowpasses
    [16, 4, 402, 960]."""
    from vfp_tpu_torch.kernels import dtcwt_level1 as dl
    from vfp_tpu_torch.ops.dtcwt import Transform2d, q2c_magnitudes
    from vfp_tpu_torch.wm import DtcwtKey

    codec, t = DtcwtKey(), Transform2d("kernel")
    h, w = cfg["scope_h"], cfg["w"]
    y_ll1 = dl.dtcwt_level1_ll_y(torch.as_tensor(smooth_frames(rng, cfg["b"], h, w),
                                                 device=device))
    y_hp2, s1 = t.analysis_qshift_hp(y_ll1)
    h2, w2 = y_hp2.shape[-2:]
    shape3 = ((h2 + 1) // 2, (w2 + 1) // 2)
    wm_hp = codec.wm_highpass(key_wm(codec, h, w, device).reshape(codec.wm_capacity((h, w, 3))))
    dsubs = codec._delta_subs(codec._masks3_from_mags(q2c_magnitudes(y_hp2), shape3), wm_hp)
    d3 = torch.cat([torch.zeros_like(dsubs[:, :4]), dsubs], dim=1)
    dll2 = t.synthesis_qshift(d3)[..., :h2, :w2].contiguous()
    dll1 = t.synthesis_qshift_ll(dll2)[..., : s1[0], : s1[1]].contiguous()
    return d3, dll2, dll1


def check_full_dtcwt_kernels(device, cfg, rng, record):
    """The six kernels of the rest of the transform against their plain
    versions on the card, which must be equal: at the new paths' shapes
    (level 1 lowpass-only on [Y; U] of a 1080p batch, [32, 1080, 1920], and
    on the mark path's Y view of the YUV batch, read in place; a
    full q-shift level on its output, [32, 4, 540, 960]; the full LeGall
    synthesis of 16 frames' level-1 planes, [16, 16, 540, 960]; path 1's
    three synthesis stages at 1920x804), then on every level of 4-level
    pyramids of 854x480, 853x480 and 2048x858 frames (odd level grids, the
    odd ones replicate-padded), and on an odd [2, 16, 33, 65] grid."""
    from vfp_tpu_torch.kernels import dtcwt_level1 as dl
    from vfp_tpu_torch.ops.color import bgr_to_yuv
    from vfp_tpu_torch.ops.dtcwt import Transform2d, _pad_even

    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    yuv = bgr_to_yuv(torch.as_tensor(smooth_frames(rng, b, h, w), device=device).to(
        torch.float32))
    compare_plain("dtcwt_level1_analysis_ll", yuv[..., 0], record,
                  "Y view of [16, 1080, 1920, 3] YUV, in place")
    x32 = torch.cat([yuv[..., 0], yuv[..., 1]]).contiguous()
    ll1 = compare_plain("dtcwt_level1_analysis_ll", x32, record, "[32, 1080, 1920]")
    compare_plain("dtcwt_qshift_analysis", ll1, record, "[32, 4, 540, 960]")
    compare_plain("dtcwt_legall_synthesis", dl.dtcwt_level1_analysis(x32[:b]), record,
                  "[16, 16, 540, 960]")
    del x32, ll1
    for name, x in zip(("dtcwt_qshift_synthesis", "dtcwt_qshift_synthesis_ll",
                        "dtcwt_legall_synthesis_ll"), scope_delta_stages(device, cfg, rng)):
        compare_plain(name, x, record, f"1920x804 {list(x.shape)}")
    plain = Transform2d("torch")
    for fh, fw in ((cfg["prime_h"], 854), (cfg["prime_h"], 853), (858, 2048)):
        x = torch.as_tensor(rng.rand(2, fh, fw).astype(np.float32) * 255, device=device)
        planes, _ = plain.forward_raw(x, 4)
        label = f"{fw}x{fh} pyramid"
        compare_plain("dtcwt_level1_analysis_ll", _pad_even(x)[0], record, label)
        for lev in range(3):
            compare_plain("dtcwt_qshift_analysis", _pad_even(planes[lev][:, :4])[0], record,
                          label)
            compare_plain("dtcwt_qshift_synthesis", planes[lev + 1], record, label)
            compare_plain("dtcwt_qshift_synthesis_ll", planes[lev + 1][:, :4], record, label)
        compare_plain("dtcwt_legall_synthesis", planes[0], record, label)
        compare_plain("dtcwt_legall_synthesis_ll", planes[0][:, :4], record, label)
    grid = torch.as_tensor(rng.randn(2, 16, 33, 65).astype(np.float32), device=device)
    for name in ("dtcwt_qshift_synthesis", "dtcwt_legall_synthesis"):
        compare_plain(name, grid, record, "[2, 16, 33, 65]")
        compare_plain(name + "_ll", grid[:, :4], record, "[2, 4, 33, 65]")
    print("kernels: DT-CWT level1_analysis_ll, qshift_analysis, qshift_synthesis(_ll), "
          "legall_synthesis(_ll) equal to their plain versions at [32, 1080, 1920] (and "
          "level1_analysis_ll on the Y view of [16, 1080, 1920, 3] YUV, in place), "
          "[32, 4, 540, 960], [16, 16, 540, 960], path 1's 1920x804 stages, every level of "
          "854x480, 853x480 and 2048x858 pyramids and a [2, 16, 33, 65] grid")


# -- phase 4: the main path -------------------------------------------------------

def _write_rawv(path, rng, n, h, w, chunk=16):
    from vfp_tpu_torch.io import RawVideoWriter

    with RawVideoWriter(path, w, h, fps=24) as writer:
        for i in range(0, n, chunk):
            writer.write_batch(natural_frames(rng, min(chunk, n - i), h, w))


def _read_rawv(path):
    from vfp_tpu_torch.io import RawVideoReader

    r = RawVideoReader(path)
    try:  # the whole file: its frames after the 24-byte header
        return r.read_batch((Path(path).stat().st_size - 24) // (r.width * r.height * 3))
    finally:
        r.close()


class NoPlainOnDevice:
    """Within the block, every plain version raises if it is given a CUDA tensor."""

    def __init__(self):
        from vfp_tpu_torch.kernels import fused_dct_qim, fused_embed, qim
        from vfp_tpu_torch.wm import dct_qim, dwt_dct_svd

        from vfp_tpu_torch.kernels import dtcwt_delta, dtcwt_level1, dtcwt_masks, dtcwt_synthesis
        from vfp_tpu_torch.ops import dtcwt

        self.targets = [(mod, name) for mod in (qim, fused_embed, fused_dct_qim, dtcwt_level1,
                                                dtcwt_masks, dtcwt_delta, dtcwt_synthesis)
                        for name in dir(mod) if name.endswith("_reference")]
        # the codecs' tensor paths
        self.targets += [(dwt_dct_svd, "top_triplet_soa"), (dct_qim, "texture_mask"),
                         (dtcwt, "down2"), (dtcwt, "up2")]
        self.saved = []

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._guard(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    @staticmethod
    def _guard(name, fn):
        def guarded(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{name} ran on a CUDA tensor on the main path")
            return fn(*args, **kwargs)
        return guarded


def run_main_path(device, cfg, workdir: Path) -> dict:
    """CLI mark -> detect at two widths, then a two-channel codec through the
    pipeline API.  Returns the launch counts of the whole phase."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.kernels.fused_embed import fused_mark_planar_reference
    from vfp_tpu_torch.pipeline import FrameExtractor, FrameMarker
    from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd, block_grid

    rng = np.random.RandomState(7)
    h, n = cfg["h"], cfg["frames"]
    batches = -(-n // cfg["b"])
    sources = {}
    for w in (cfg["w"], cfg["narrow_w"]):
        sources[w] = workdir / f"in_{w}x{h}.rawv"
        _write_rawv(sources[w], rng, n, h, w)
    frames_mc = natural_frames(rng, cfg["b"], h, cfg["w"])

    fresh_counts()
    with NoPlainOnDevice():
        for w, names in ((cfg["w"], ("fused_mark_planar", "fused_extract_planar")),
                         (cfg["narrow_w"], ("qim_triplet_soa", "qim_decode_soa"))):
            before = kernels.launch_counts()
            out = workdir / f"marked_{w}x{h}.rawv"
            flags = ["--batch-size", str(cfg["b"]), "--device", str(device)]
            cli(["mark", str(sources[w]), str(out), *flags])
            # exits 1 unless the majority payload matches
            cli(["detect", str(out), "--payload", PAYLOAD, *flags])
            after = kernels.launch_counts()
            for name in names:
                assert after[name] - before[name] == batches, (w, name, before, after)
            print(f"main path {w}x{h}: {n} frames marked and detected, launches "
                  f"{ {k: after[k] - before[k] for k in names} }")

        codec = DwtDctSvd(scales=(5.0, 15.0, 0.0))
        wm = spread_wm(codec, h, cfg["w"], "cpu").numpy()
        marked = FrameMarker(codec, wm, cfg["b"], device=device).mark(frames_mc)
        deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
        payloads = FrameExtractor(codec, deg, cfg["b"], device=device).extract(marked)
        want = np.array([int(c) for c in PAYLOAD], np.uint8)
        assert (payloads == want).all(), payloads
        print(f"main path two-channel codec {cfg['w']}x{h}: payload recovered in "
              f"{len(payloads)}/{len(payloads)} frames")
    counts = kernels.launch_counts()
    flagship = list(REPLACES)[:5]
    assert all(counts[k] > 0 for k in flagship), counts
    assert not any(counts[k] for k in REPLACES if k not in flagship), counts
    counts = {k: counts[k] for k in flagship}

    # what came out is right: shape, fidelity, and agreement with the plain version
    src, out = _read_rawv(sources[cfg["w"]]), _read_rawv(workdir / f"marked_{cfg['w']}x{h}.rawv")
    assert out.shape == (n, h, cfg["w"], 3), out.shape
    mse = float(np.mean((out.astype(np.float64) - src) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 40.0, psnr
    codec = DwtDctSvd()
    (nbh, nbw), _ = block_grid((h, cfg["w"]))
    x = torch.as_tensor(np.array(src[: cfg["b"]]), device=device).permute(0, 3, 1, 2)
    wm2d = spread_wm(codec, h, cfg["w"], device)[: nbh * nbw].reshape(nbh, nbw)
    want = fused_mark_planar_reference(x, wm2d, 15.0, 1).permute(0, 2, 3, 1).cpu().numpy()
    same = float((want == out[: cfg["b"]]).mean())
    assert same >= 0.995, same
    print(f"main path output: PSNR {psnr:.2f} dB vs source, {same:.6f} of the first "
          f"batch's pixels equal to the plain version")
    return counts, sources[cfg["w"]]


def run_dct_path(device, cfg, workdir: Path, source: Path) -> dict:
    """``cli mark --codec dct`` -> ``detect --codec dct`` on the 1920x1080 file;
    returns the launch counts of that run alone."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.kernels.fused_dct_qim import fused_dct_qim_mark_reference
    from vfp_tpu_torch.wm import DctQim

    h, w, n = cfg["h"], cfg["w"], cfg["frames"]
    batches = -(-n // cfg["b"])
    out = workdir / f"marked_dct_{w}x{h}.rawv"
    flags = ["--codec", "dct", "--batch-size", str(cfg["b"]), "--device", str(device)]
    fresh_counts()
    with NoPlainOnDevice():
        cli(["mark", str(source), str(out), *flags])
        cli(["detect", str(out), "--payload", PAYLOAD, *flags])  # exits 1 on a wrong payload
    counts = kernels.launch_counts()
    # the mark takes y_dc_mean's means; detect's extract takes its own
    want = {"fused_dct_qim_mark": batches, "fused_dct_qim_extract": batches,
            kernels.EXTRACT_DECIDE: batches, "y_dc_mean": batches}
    assert_counts(counts, want, "dct")
    counts = {k: counts[k] for k in want}
    print(f"main path dct {w}x{h}: {n} frames marked and detected, launches {counts}")

    src, marked = _read_rawv(source), _read_rawv(out)
    assert marked.shape == (n, h, w, 3), marked.shape
    mse = float(np.mean((marked.astype(np.float64) - src) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 40.0, psnr
    codec = DctQim()
    x = torch.as_tensor(np.array(src[: cfg["b"]]), device=device).permute(0, 3, 1, 2)
    wm2d = spread_wm(codec, h, w, device)[: (h // 8) * (w // 8)].reshape(h // 8, w // 8)
    want_px = fused_dct_qim_mark_reference(x, wm2d, ALPHA).permute(0, 2, 3, 1).cpu().numpy()
    same = float((want_px == marked[: cfg["b"]]).mean())
    assert same >= 0.995, same
    print(f"main path dct output: PSNR {psnr:.2f} dB vs source, {same:.6f} of the first "
          f"batch's pixels equal to the plain version")
    return counts


@contextlib.contextmanager
def plain_kernels():
    """Within the block, every DT-CWT kernel wrapper is replaced by its plain
    version (on the card too), wherever the port looks it up: the codec's
    kernel path then runs with the plain versions.  The watermark-spectrum
    cache is emptied on the way in and out, so neither side reuses a
    spectrum the other computed."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.kernels import dtcwt_delta, dtcwt_level1, dtcwt_masks, dtcwt_synthesis
    from vfp_tpu_torch.wm import dtcwt_codecs

    saved = []
    for fn in kernels.KERNELS:
        home = sys.modules[fn.__module__]
        for mod in (dtcwt_level1, dtcwt_masks, dtcwt_delta, dtcwt_synthesis, dtcwt_codecs):
            if getattr(mod, fn.__name__, None) is fn:
                saved.append((mod, fn.__name__, fn))
                setattr(mod, fn.__name__, getattr(home, fn.__name__ + "_reference"))
    dtcwt_codecs.clear_wm_cache()
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        dtcwt_codecs.clear_wm_cache()


def fresh_counts() -> None:
    """Every launch count to 0 and the watermark-spectrum cache emptied, just
    before a path: each path then computes its spectrum once, whatever ran
    before it."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.wm import clear_wm_cache

    clear_wm_cache()
    kernels.reset_launch_counts()


def assert_counts(counts, want, label):
    """Exactly the kernels of ``want`` ran, each as often as it says."""
    assert all(counts[k] == v for k, v in want.items()), (label, counts, want)
    assert not any(v for k, v in counts.items() if k not in want), (label, counts, want)


def _cli_lines(cli, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(argv)
    return out.getvalue()


def run_dtcwt_path(device, cfg, workdir: Path):
    """``cli mark --codec dtcwtKey`` on a 48-frame smooth 1920x1080 file, then
    ``cli detect --codec dtcwtKey`` on the card with key 0 (48/48 present)
    and key 99 (0/48); the first batch's correlations against the plain
    kernel path on the card, and the port's tensor-path extract (CPU) on two
    frames.  Returns the launch counts of the mark run plus the key-0 detect
    run, each counted alone, and the source file."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.io import RawVideoWriter
    from vfp_tpu_torch.wm import DeCorrShuffler, DtcwtKey

    rng = np.random.RandomState(11)
    h, w, n = cfg["h"], cfg["w"], cfg["frames"]
    batches = -(-n // cfg["b"])
    source, out = workdir / f"smooth_{w}x{h}.rawv", workdir / f"marked_dtcwt_{w}x{h}.rawv"
    with RawVideoWriter(source, w, h, fps=24) as writer:
        for i in range(0, n, cfg["b"]):
            writer.write_batch(smooth_frames(rng, min(cfg["b"], n - i), h, w))
    flags = ["--codec", "dtcwtKey", "--batch-size", str(cfg["b"]), "--device", str(device)]
    fresh_counts()
    with NoPlainOnDevice():
        cli(["mark", str(source), str(out), *flags])
    counts = kernels.launch_counts()
    # the watermark plane's spectrum once per run, the rest once per batch
    assert_counts(counts, {**{k: batches for k in DTCWT}, "dtcwt_level1_analysis": 1},
                  "dtcwtKey mark")
    mark_counts = {k: counts[k] for k in DTCWT}
    print(f"main path dtcwtKey {w}x{h}: {n} frames marked, launches {mark_counts}")

    def detect(key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = _cli_lines(cli, ["detect", str(out), "--key", str(key), *flags])
        return text, time.perf_counter() - t0

    fresh_counts()
    with NoPlainOnDevice():
        lines, seconds = detect(0)
    counts = kernels.launch_counts()
    assert_counts(counts, {k: batches for k in DTCWT_DETECT}, "dtcwtKey detect")
    detect_counts = {k: counts[k] for k in DTCWT_DETECT}
    with NoPlainOnDevice():
        lines_99, seconds_99 = detect(99)
    for text, want in ((lines, f"{n}/{n}"), (lines_99, f"0/{n}")):
        assert f"frames: {n}" in text and f"watermark present in {want} frames" in text, text
    print(f"main path dtcwtKey detect {w}x{h} --device {device}: key 0 "
          f"{lines.strip().splitlines()[-1]!r}, key 99 {lines_99.strip().splitlines()[-1]!r}; "
          f"{n} frames in {seconds:.3f} s ({n / seconds:.1f} frames/s; key 99, the second run: "
          f"{seconds_99:.3f} s, {n / seconds_99:.1f} frames/s; host clock around the CLI call, "
          f"the file read and the keyed plane included), launches {detect_counts}")

    src, marked = _read_rawv(source), _read_rawv(out)
    assert marked.shape == (n, h, w, 3), marked.shape
    mse = float(np.mean((marked.astype(np.float64) - src) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 35.0, psnr
    codec = DtcwtKey()
    x = torch.as_tensor(np.array(src[: cfg["b"]]), device=device)
    with plain_kernels():
        want = codec.mark_frames(x, key_wm(codec, h, w, device)).cpu().numpy()
    same = float((want == marked[: cfg["b"]]).mean())
    assert same >= 0.995, same
    first = torch.as_tensor(np.array(marked[: cfg["b"]]), device=device)
    deg = DeCorrShuffler(0)
    got_corr = deg.correlation_batch(codec.extract_frames(first))
    with plain_kernels():
        want_corr = deg.correlation_batch(codec.extract_frames(first))
    corr_err = float((got_corr - want_corr).abs().max())
    assert corr_err <= 1e-4, corr_err
    plain = DtcwtKey(backend="torch")
    planes = plain.extract_frames(torch.as_tensor(np.array(marked[:2]), device="cpu"))
    corr = {key: DeCorrShuffler(key).correlation_batch(planes).tolist() for key in (0, 99)}
    assert all(c > 0.1 for c in corr[0]) and all(c < 0.1 for c in corr[99]), corr
    print(f"main path dtcwtKey output: PSNR {psnr:.2f} dB vs source, {same:.6f} of the first "
          f"batch's pixels equal to the plain version on the card; first batch's key-0 "
          f"correlations (min {float(got_corr.min()):.4f}) within {corr_err:.3g} of the plain "
          f"kernel path on the card; tensor-path extract (CPU) correlation key 0 "
          f"{[round(c, 4) for c in corr[0]]}, key 99 {[round(c, 4) for c in corr[99]]}")
    return collections.Counter(mark_counts) + collections.Counter(detect_counts), source


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(255.0 ** 2 / mse)


def run_dtcwt_scope_path(device, cfg, workdir: Path) -> dict:
    """Path 1: ``cli mark`` -> ``cli detect --codec dtcwtKey`` on a 48-frame
    smooth 1920x804 file (a 2.39:1 scope film at 1080p width; H % 8 == 4, so
    no level but level 1 halves exactly).  Mark: ``dtcwt_level1_ll_y``, the Y
    level 2 highpass-only, the mask glue, then ``dtcwt_qshift_synthesis`` ->
    crop to 201 rows -> ``dtcwt_qshift_synthesis_ll`` ->
    ``dtcwt_legall_synthesis_ll``.  Detect: ``dtcwt_level1_ll_color``, U
    level 2 (201x480) padded to 202 rows, U level 3, the mask glue on the Y
    level 2, ``dtcwt_legall_synthesis_hp`` on the folded 51x120 planes.  Key
    0 must be found in 48/48 frames, key 99 in 0/48, PSNR > 35 dB, and the
    first batch equal to the same path with the kernels' plain versions on
    the card.  Returns the launch counts of the mark and key-0 detect runs."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.io import RawVideoWriter
    from vfp_tpu_torch.wm import DtcwtKey

    rng = np.random.RandomState(17)
    h, w, n, b = cfg["scope_h"], cfg["w"], cfg["frames"], cfg["b"]
    batches = -(-n // b)
    source, out = workdir / f"smooth_{w}x{h}.rawv", workdir / f"marked_dtcwt_{w}x{h}.rawv"
    with RawVideoWriter(source, w, h, fps=24) as writer:
        for i in range(0, n, b):
            writer.write_batch(smooth_frames(rng, min(b, n - i), h, w))
    flags = ["--codec", "dtcwtKey", "--batch-size", str(b), "--device", str(device)]
    fresh_counts()
    with NoPlainOnDevice():
        mark_lines = _cli_lines(cli, ["mark", str(source), str(out), *flags])
    mark_counts = kernels.launch_counts()
    assert_counts(mark_counts, {"dtcwt_level1_analysis": 1, **{k: batches for k in (
        "dtcwt_level1_ll_y", "dtcwt_qshift_hp", "dtcwt_qshift_synthesis",
        "dtcwt_qshift_synthesis_ll", "dtcwt_legall_synthesis_ll")}}, "scope mark")

    def detect(key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = _cli_lines(cli, ["detect", str(out), "--key", str(key), *flags])
        return text, time.perf_counter() - t0

    fresh_counts()
    with NoPlainOnDevice():
        lines, seconds = detect(0)
    detect_counts = kernels.launch_counts()
    assert_counts(detect_counts, {"dtcwt_level1_ll_color": batches, "dtcwt_qshift_ll": batches,
                                  "dtcwt_qshift_hp": 2 * batches,
                                  "dtcwt_legall_synthesis_hp": batches}, "scope detect")
    with NoPlainOnDevice():
        lines_99, seconds_99 = detect(99)
    for text, want in ((lines, f"{n}/{n}"), (lines_99, f"0/{n}")):
        assert f"frames: {n}" in text and f"watermark present in {want} frames" in text, text
    src, marked = _read_rawv(source), _read_rawv(out)
    assert marked.shape == (n, h, w, 3), marked.shape
    psnr = _psnr(marked, src)
    assert psnr > 35.0, psnr
    codec = DtcwtKey()
    with plain_kernels():
        want = codec.mark_frames(torch.as_tensor(np.array(src[:b]), device=device),
                                 key_wm(codec, h, w, device)).cpu().numpy()
    same = float((want == marked[:b]).mean())
    assert same == 1.0, same
    counts = collections.Counter(mark_counts) + collections.Counter(detect_counts)
    print(f"main path dtcwtKey {w}x{h}: {mark_lines.strip().splitlines()[0]!r}; detect key 0 "
          f"{lines.strip().splitlines()[-1]!r} in {seconds:.3f} s ({n / seconds:.1f} frames/s), "
          f"key 99 {lines_99.strip().splitlines()[-1]!r} in {seconds_99:.3f} s "
          f"({n / seconds_99:.1f} frames/s; host clock around the CLI call); PSNR {psnr:.2f} dB; "
          f"first batch equal to the plain kernel path on the card; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def run_dtcwt_float_path(device, cfg) -> dict:
    """Path 2: one [16, 1080, 1920, 3] float32 batch of integer values through
    ``DtcwtKey.mark_frames`` / ``extract_frames`` on the card: the
    ``bgr_to_yuv`` channel path, ``dtcwt_level1_analysis_ll`` on Y (mark) and
    on [Y; U] (detect), then the fused masks and delta kernels (1080p is a
    multiple of 8).  Both outputs must equal the same path with the kernels'
    plain versions on the card, and detection must find key 0 (not key 99)
    in every frame.  Returns its launch counts."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.wm import DeCorrShuffler, DtcwtKey

    rng = np.random.RandomState(19)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    codec = DtcwtKey()
    src = smooth_frames(rng, b, h, w)
    frames = torch.as_tensor(src, device=device).to(torch.float32)
    wm = key_wm(codec, h, w, device)
    fresh_counts()
    with NoPlainOnDevice():
        marked = codec.mark_frames(frames, wm)
        planes = codec.extract_frames(marked.to(torch.float32))
    counts = kernels.launch_counts()
    assert_counts(counts, {"dtcwt_level1_analysis_ll": 2, "dtcwt_level1_analysis": 1,
                           "dtcwt_qshift_masks": 2, "dtcwt_delta_synthesis": 1,
                           "dtcwt_qshift_ll": 1, "dtcwt_qshift_hp": 1,
                           "dtcwt_legall_synthesis_hp": 1}, "float path")
    with plain_kernels():
        want_marked = codec.mark_frames(frames, wm)
        want_planes = codec.extract_frames(marked.to(torch.float32))
    assert torch.equal(marked, want_marked), float((marked == want_marked).float().mean())
    assert torch.equal(planes, want_planes), float((planes - want_planes).abs().max())
    corr = {key: DeCorrShuffler(key).correlation_batch(planes) for key in (0, 99)}
    assert bool((corr[0] > 0.1).all()) and bool((corr[99] < 0.1).all()), corr
    psnr = _psnr(marked.cpu().numpy(), src)
    assert psnr > 35.0, psnr
    print(f"main path dtcwtKey float frames {b}x{h}x{w}: marked and extracted on the kernels, "
          f"both equal to the plain kernel path on the card; PSNR {psnr:.2f} dB; correlation "
          f"key 0 min {float(corr[0].min()):.4f}, key 99 max {float(corr[99].max()):.4f}; "
          f"launches { {k: v for k, v in counts.items() if v} }")
    return counts


def run_dtcwt_depth_path(device, cfg, workdir: Path, source_1080p: Path) -> dict:
    """Path 3: ``DtcwtKey(nlevels=4)`` through the pipeline API
    (``FrameMarker`` per 16-frame batch, then ``codec.extract_frames``) on a
    48-frame smooth 1280x720 file: ``forward_raw`` over [Y; U] (level 1, then
    three full q-shift levels, 360x640, 180x320 and 90x160), the delta on
    level 4, ``inverse_raw`` of U (three q-shift syntheses, the full LeGall
    synthesis).  At 4 levels the JAX codec, and so the port, takes only
    frames whose level-2 grid rebins onto level 4 (H, W % 16 == 0 for even
    frames): 720p does, 1080p does not (270 rows onto 68).  The first
    batch's marked frames and recovered planes must equal the same path
    with the kernels' plain versions on the card; its correlations are
    printed, not held (the JAX codec detects its own mark only at 3
    levels).  Then ``Transform2d.forward(x, 4)`` -> ``inverse`` of a
    [16, 1080, 1920] float batch (channel 0 of the 1080p file) on the
    kernels must reconstruct within 2e-3.  Returns the launch counts of both
    runs."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.io import RawVideoWriter
    from vfp_tpu_torch.ops.dtcwt import Transform2d
    from vfp_tpu_torch.pipeline import FrameMarker
    from vfp_tpu_torch.wm import CorrShuffler, DeCorrShuffler, DtcwtKey

    rng = np.random.RandomState(23)
    b, n, h, w = cfg["b"], cfg["frames"], cfg["depth_h"], cfg["depth_w"]
    batches = -(-n // b)
    source = workdir / f"smooth_{w}x{h}.rawv"
    with RawVideoWriter(source, w, h, fps=24) as writer:
        for i in range(0, n, b):
            writer.write_batch(smooth_frames(rng, min(b, n - i), h, w))
    frames = _read_rawv(source)
    codec = DtcwtKey(nlevels=4)
    marker = FrameMarker(codec, CorrShuffler(0).generate_wm(None, codec.wm_capacity((h, w, 3))),
                         b, device=device)
    fresh_counts()
    with NoPlainOnDevice():
        marked = np.concatenate([marker.mark(frames[i:i + b]) for i in range(0, n, b)])
        planes = torch.cat([codec.extract_frames(torch.as_tensor(marked[i:i + b], device=device))
                            for i in range(0, n, b)])
    counts = kernels.launch_counts()
    # level 1 of [Y; U] per mark and extract batch, the spectrum once per run
    assert_counts(counts, {"dtcwt_level1_analysis": 2 * batches + 1,
                           "dtcwt_qshift_analysis": 6 * batches,
                           "dtcwt_qshift_synthesis": 3 * batches,
                           "dtcwt_legall_synthesis": batches,
                           "dtcwt_legall_synthesis_hp": batches}, "nlevels=4 path")
    with plain_kernels():
        want_marked = codec.mark_frames(torch.as_tensor(np.array(frames[:b]), device=device),
                                        marker.wm).cpu().numpy()
        want_planes = codec.extract_frames(torch.as_tensor(marked[:b], device=device))
    same = float((want_marked == marked[:b]).mean())
    assert same == 1.0, same
    assert torch.equal(planes[:b], want_planes), float((planes[:b] - want_planes).abs().max())
    corr = {key: DeCorrShuffler(key).correlation_batch(planes).cpu().numpy() for key in (0, 99)}

    x = torch.as_tensor(np.array(_read_rawv(source_1080p)[:b, ..., 0]), device=device).to(
        torch.float32)
    t = Transform2d()
    fresh_counts()
    with NoPlainOnDevice():
        rec = t.inverse(t.forward(x, nlevels=4))
    transform_counts = kernels.launch_counts()
    assert_counts(transform_counts, {"dtcwt_level1_analysis": 1, "dtcwt_qshift_analysis": 3,
                                     "dtcwt_qshift_synthesis": 3, "dtcwt_legall_synthesis": 1},
                  "forward -> inverse")
    rec_err = float((rec - x).abs().max())
    assert rec_err <= 2e-3, rec_err
    print(f"main path dtcwtKey nlevels=4 {w}x{h}: {n} frames through FrameMarker and "
          f"extract_frames, PSNR {_psnr(marked, frames):.2f} dB, first batch's marks and planes "
          f"equal to the plain kernel path on the card; correlation key 0 mean "
          f"{corr[0].mean():.4f} (min {corr[0].min():.4f}), key 99 mean {corr[99].mean():.4f} "
          f"(not held: the JAX codec detects only at 3 levels); launches "
          f"{ {k: v for k, v in counts.items() if v} }; Transform2d forward(nlevels=4) -> "
          f"inverse of {list(x.shape)} on the kernels: max err {rec_err:.3g} on 0-255 values, "
          f"launches { {k: v for k, v in transform_counts.items() if v} }")
    return collections.Counter(counts) + collections.Counter(transform_counts)


HLS = {"n": 180, "fps": 30, "copies": 3, "seg_frames": 60}  # the hls and parallel phases
# the ffmpeg phase's cli durability: 90 1080p frames at HLS["fps"], 1 s segments
DURABILITY_FFMPEG = {"n": 90, "segments": 3}


def run_hls_path(device, cfg, workdir: Path) -> tuple[dict, dict]:
    """The HLS fingerprinting workflow through the port's CLI on a 1920x1080,
    30 fps .rawv of 180 frames (three 2 s segments of 60): ``hls-mark
    --copies 3``, ``leak --pattern 201`` -> ``trace`` with the manifests,
    then ``leak --pattern 120`` -> ``trace`` blind.  Each intermediate is
    deleted once the workflow no longer needs it.  Checks the printed
    results, the launches (the marks: 3 segments x 4 batches x 3 variants;
    the extracts: verify packs 540 frames across files into 34 batches, each
    trace 180 into 12), the PSNR of a variant against its source segment,
    its first batch against ``fused_mark_planar_reference`` with that
    variant's own watermark, and ``MultiMarker.submit``/``collect`` with
    four handles in flight against ``mark_all``.  Keeps the source and
    ``hls/out`` (the marked variants and manifests) for the parallel phase.  Returns the
    launch counts of the workflow and ``mark_segments``' stats."""
    import ast
    import shutil

    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.fingerprint import marker, payload_for_segment
    from vfp_tpu_torch.io import RawVideoWriter
    from vfp_tpu_torch.kernels.fused_embed import fused_mark_planar_reference
    from vfp_tpu_torch.pipeline import MultiMarker
    from vfp_tpu_torch.wm import DwtDctSvd, Shuffler, block_grid

    h, w, b = cfg["h"], cfg["w"], cfg["b"]
    n, fps, copies, seg_frames = HLS["n"], HLS["fps"], HLS["copies"], HLS["seg_frames"]
    root = workdir / "hls"
    root.mkdir()
    print(f"hls: {shutil.disk_usage(root).free / 1e9:.1f} GB free on the work disk "
          f"before the phase")
    rng = np.random.RandomState(12)
    src = root / "source.rawv"
    with RawVideoWriter(src, w, h, fps=fps) as writer:
        for i in range(0, n, b):
            writer.write_batch(natural_frames(rng, min(b, n - i), h, w))
    out = root / "out"
    flags = ["--batch-size", str(b), "--device", str(device)]
    verify_s = []
    verify_segments = marker.verify_segments

    def timed_verify(*args, **kwargs):  # the CLI's verify, timed apart
        t0 = time.perf_counter()
        res = verify_segments(*args, **kwargs)
        torch.cuda.synchronize()
        verify_s.append(time.perf_counter() - t0)
        return res

    submit_s = []
    submit = MultiMarker.submit

    def timed_submit(self, frames):  # the submitting thread's share of hls-mark
        t0 = time.perf_counter()
        handle = submit(self, frames)
        submit_s.append(time.perf_counter() - t0)
        return handle

    open_s = []
    open_writer = marker.open_writer

    def timed_open(*args, **kwargs):  # opening a variant's writer, on the same thread
        t0 = time.perf_counter()
        writer = open_writer(*args, **kwargs)
        open_s.append(time.perf_counter() - t0)
        return writer

    codec = DwtDctSvd()
    variant = (0, 1)  # segment 0, copy 1
    fresh_counts()
    marker.verify_segments = timed_verify
    MultiMarker.submit = timed_submit
    marker.open_writer = timed_open
    try:
        with NoPlainOnDevice():
            text = _cli_lines(cli, ["hls-mark", str(src), str(out), "--copies", str(copies),
                                    *flags])
            assert f"created {n // seg_frames} segments" in text, text
            assert "All segments were watermarked successfully!" in text, text
            stats = ast.literal_eval(text.split("mark_segments stats: ", 1)[1].splitlines()[0])
            source_seg = _read_rawv(out / "segments" / "segment_000.rawv")
            marked = _read_rawv(out / "marked_segments" /
                                f"marked_seg{variant[0]}_copy{variant[1]}.rawv")
            psnr = _psnr(marked, source_seg)
            source_seg, marked = np.array(source_seg[:b]), np.array(marked[:b])
            for p in (out / "segments", out / "hls"):  # the leak needs neither
                shutil.rmtree(p) if p.is_dir() else p.unlink()
            traces = {}
            for pattern, blind in (("201", False), ("120", True)):
                leaked = root / f"leak_{pattern}.rawv"
                text = _cli_lines(cli, ["leak", str(out / "segment_copies.json"), "--pattern",
                                        pattern, "--output-file", str(leaked), *flags[2:]])
                assert f"pattern: {pattern}" in text, text
                manifests = [] if blind else ["--payload-file",
                                              str(out / "segment_payloads.json")]
                t0 = time.perf_counter()
                text = _cli_lines(cli, ["trace", str(leaked), str(root / f"det_{pattern}"),
                                        *manifests, "--max-copies", str(copies), *flags[2:]])
                traces[pattern] = time.perf_counter() - t0
                assert f"Copy fingerprint: {pattern}" in text, text
                assert "Success rate: 100.00%" in text, text
                leaked.unlink()
                shutil.rmtree(root / f"det_{pattern}")
    finally:
        marker.verify_segments = verify_segments
        MultiMarker.submit = submit
        marker.open_writer = open_writer
    counts = kernels.launch_counts()
    n_variants = copies * n
    want = {"fused_mark_planar": (n // seg_frames) * -(-seg_frames // b) * copies,
            "fused_extract_planar": -(-n_variants // b) + 2 * -(-n // b)}
    assert_counts(counts, want, "hls")
    counts = {k: counts[k] for k in want}
    assert psnr > 40.0, psnr

    wm = Shuffler(key=0).generate_wm(payload_for_segment(*variant), codec.wm_capacity((h, w, 3)))
    (nbh, nbw), _ = block_grid((h, w))
    wm2d = torch.as_tensor(np.asarray(wm, np.float32).reshape(-1)[: nbh * nbw].reshape(nbh, nbw),
                           device=device)
    x = torch.as_tensor(source_seg, device=device).permute(0, 3, 1, 2)
    want_px = fused_mark_planar_reference(x, wm2d, 15.0, 1).permute(0, 2, 3, 1).cpu().numpy()
    same = float((want_px == marked).mean())
    assert same >= 0.995, same

    wms = [Shuffler(key=0).generate_wm(payload_for_segment(0, c), codec.wm_capacity((h, w, 3)))
           for c in range(copies)]
    mm = MultiMarker(codec, wms, b, device=device)
    batches = [natural_frames(rng, b - i % 2, h, w) for i in range(4)]
    handles = [mm.submit(f) for f in batches]  # four in flight before the first collect
    outs = [mm.collect(hd) for hd in handles]
    for f, o in zip(batches, outs):
        assert np.array_equal(o, mm.mark_all(f)), "submit/collect differs from mark_all"

    stage = stats["stage_seconds"]
    print(f"hls: hls-mark {n} frames of {w}x{h} at {fps} fps, {copies} copies: "
          f"{n_variants / stats['wall_seconds']:.1f} variant-frames/s of mark_segments "
          f"({n_variants} in {stats['wall_seconds']} s); stats {stats}; {len(submit_s)} "
          f"submits {sum(submit_s):.3f} s (first {submit_s[0]:.3f}, median "
          f"{float(np.median(submit_s)):.3f}); {len(open_s)} writers opened in "
          f"{sum(open_s):.3f} s")
    print(f"hls: verify {n_variants} frames in {verify_s[0]:.3f} s "
          f"({n_variants / verify_s[0]:.1f} frames/s); trace 201 (manifests) "
          f"{n / traces['201']:.1f} frames/s, trace 120 (blind) {n / traces['120']:.1f} "
          f"frames/s, {n} frames each (CLI wall, re-segmenting included)")
    print(f"hls: Copy fingerprint 201 and blind 120 recovered, 100% success; PSNR "
          f"{psnr:.2f} dB of segment {variant[0]} copy {variant[1]} vs its source, {same:.6f} "
          f"of its first batch's pixels equal to the plain version; 4 submits in flight equal "
          f"mark_all; launches {counts}; card {nvidia_smi_line()}")
    return counts, stats


def _http(base, path, data=None, headers=None):
    """(status, body, headers) of one request; an HTTP error status is
    returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _multipart(name: str, payload: bytes):
    boundary = "vfpchipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
    return (body + payload + f"\r\n--{boundary}--\r\n".encode(),
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})


def run_serve_path(device, cfg, workdir: Path) -> dict:
    """The fingerprinting HTTP service of the port on a thread
    (``make_server(..., num_copies=3, segment_duration=2.0, device="cuda")``),
    driven over HTTP: ``/upload`` of 180 natural 1920x1080 frames at 30 fps
    (3 segments, 9 variants, 36 ``fused_mark_planar``), ``/start-view`` for
    three users (view numbers 0, 1, 2), their playlists against
    ``pattern_for_view``, one ``/hls`` file, ``/download-view``, ``/detect`` of
    user 1's segment 2 (copy 1: views 0, 1, 2 play [0,0,0], [0,0,1],
    [0,0,2], so exactly one match, user 1, at frequency 1.0; 4
    ``fused_extract_planar``), then two ``/detect`` requests at once from two
    threads (equal responses; the handler threads share the cached
    extractor and the pinned staging buffer), the PSNR of a variant, and
    the three pages.  The service's stages are timed apart (``split``: the
    seconds inside each wrapped function, summed over threads).  Returns
    the launch counts of the phase."""
    import shutil
    import threading

    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.fingerprint import pattern_for_view
    from vfp_tpu_torch.io import RawVideoWriter
    from vfp_tpu_torch.serve import app as app_mod, service as service_mod
    from vfp_tpu_torch.serve.app import make_server

    split = collections.defaultdict(float)
    saved = []

    def timed_stage(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[name] += time.perf_counter() - t0
        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)

    h, w, b = cfg["h"], cfg["w"], cfg["b"]
    n, fps, copies, seg_frames = 180, 30, 3, 60
    root = workdir / "serve"
    root.mkdir()
    rng = np.random.RandomState(13)
    src = root / "source.rawv"
    with RawVideoWriter(src, w, h, fps=fps) as writer:
        for i in range(0, n, b):
            writer.write_batch(natural_frames(rng, min(b, n - i), h, w))
    body, headers = _multipart("source.rawv", src.read_bytes())
    upload_gb = len(body) / 1e9
    src.unlink()
    data_dir = root / "data"
    srv = make_server("127.0.0.1", 0, data_dir, num_copies=copies, segment_duration=2.0,
                      device=device)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    t = {}
    splits = {}
    counts = collections.Counter()
    for mod, name in ((app_mod, "parse_multipart"), (service_mod, "_check_upload"),
                      (service_mod, "segment_video"), (service_mod, "mark_segments"),
                      (service_mod, "write_hls_playlists"), (service_mod, "_read_all"),
                      (service_mod, "concatenate_segments")):
        timed_stage(mod, name)

    def timed(key, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _http(base, *args)
        t[key] = time.perf_counter() - t0
        return out

    try:
        with NoPlainOnDevice():
            fresh_counts()
            split.clear()
            status, resp, _ = timed("upload", "/upload", body, headers)
            splits["upload"] = dict(split)
            assert status == 200, (status, resp[:500])
            summary = json.loads(resp)
            assert (summary["status"], summary["num_segments"], summary["total_variants"],
                    summary["failed_segments"]) == ("success", n // seg_frames,
                                                    copies * n // seg_frames, []), summary
            marks = kernels.launch_counts()
            assert_counts(marks, {"fused_mark_planar": (n // seg_frames) * -(-seg_frames // b)
                                  * copies}, "serve upload")
            counts.update(marks)
            del body
            views = []
            for i, user in enumerate(("user0", "user1", "user2")):
                status, resp, _ = timed(f"start_view{i}", "/start-view",
                                        json.dumps({"username": user}).encode(),
                                        {"Content-Type": "application/json"})
                assert status == 200, resp
                views.append(json.loads(resp))
            assert [v["view_number"] for v in views] == [0, 1, 2], views
            for i, v in enumerate(views):
                status, m3u8, hdrs = timed(f"playlist{i}", f"/view/{v['view_id']}")
                assert status == 200 and hdrs["Cache-Control"] == "no-cache", hdrs
                names = [ln[len("/hls/"):] for ln in m3u8.decode().splitlines()
                         if ln.startswith("/hls/")]
                seq = [int(re.search(r"copy(\d+)", nm).group(1)) for nm in names]
                assert seq == pattern_for_view(v["view_number"], copies, n // seg_frames), names
            status, seg, _ = timed("hls", f"/hls/{names[0]}")
            assert status == 200 and seg == (data_dir / "hls" / names[0]).read_bytes()
            status, spliced, hdrs = timed("download", f"/download-view/{views[1]['view_id']}")
            assert status == 200 and len(spliced) == 24 + n * h * w * 3, (status, len(spliced))
            assert hdrs["Content-Disposition"].endswith(f'view_{views[1]["view_id"]}.rawv"')
            del spliced
            leak = data_dir / "hls" / "marked_seg002_copy1.rawv"
            leak_body, leak_headers = _multipart(leak.name, leak.read_bytes())
            fresh_counts()
            split.clear()
            status, resp, _ = timed("detect", "/detect", leak_body, leak_headers)
            splits["detect"] = dict(split)
            assert status == 200, resp
            found = json.loads(resp)
            assert_counts(kernels.launch_counts(), {"fused_extract_planar": -(-seg_frames // b)},
                          "serve detect")
            counts.update(kernels.launch_counts())
            assert (found["status"], found["segment_number"], found["copy_index"],
                    found["frequency"]) == ("success", 2, 1, 1.0), found
            assert [(m["username"], m["frequency"]) for m in found["matches"]] == [
                ("user1", 1.0)], found
            fresh_counts()
            results = [None, None]

            def post(k):
                results[k] = _http(base, "/detect", leak_body, leak_headers)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pair = [threading.Thread(target=post, args=(k,)) for k in range(2)]
            for th in pair:
                th.start()
            for th in pair:
                th.join(timeout=600)
            t["detect_pair"] = time.perf_counter() - t0
            assert not any(th.is_alive() for th in pair)
            assert all(r[0] == 200 for r in results), results
            assert json.loads(results[0][1]) == json.loads(results[1][1]) == found
            assert_counts(kernels.launch_counts(),
                          {"fused_extract_planar": 2 * -(-seg_frames // b)}, "serve detect pair")
            counts.update(kernels.launch_counts())
            for page in ("/", "/view", "/detect"):
                status, html, _ = _http(base, page)
                assert status == 200 and b"<html>" in html, (page, status)
        psnr = _psnr(_read_rawv(data_dir / "hls" / "marked_seg000_copy1.rawv"),
                     _read_rawv(data_dir / "segments" / "segment_000.rawv"))
        assert psnr > 40.0, psnr
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    n_variants = copies * n
    starts = ", ".join(f"{t['start_view%d' % i] * 1e3:.3f}" for i in range(3))
    gets = ", ".join(f"{t['playlist%d' % i] * 1e3:.3f}" for i in range(3))
    print(f"serve: /upload {n} frames of {w}x{h} at {fps} fps, {copies} copies: "
          f"{t['upload']:.3f} s ({n_variants / t['upload']:.1f} variant-frames/s; the "
          f"{upload_gb:.2f} GB request body sent over localhost included); /start-view "
          f"{starts} ms; playlist GET {gets} ms; /hls GET of one "
          f"variant ({len(seg) / 1e6:.1f} MB) {t['hls'] * 1e3:.3f} ms; /download-view "
          f"{t['download']:.3f} s; /detect of {seg_frames} frames {t['detect']:.3f} s "
          f"({seg_frames / t['detect']:.1f} frames/s), two at once {t['detect_pair']:.3f} s "
          f"({2 * seg_frames / t['detect_pair']:.1f} frames/s); host clock around each request; "
          f"card {nvidia_smi_line()}")
    for key in ("upload", "detect"):
        parts = ", ".join(f"{k} {v:.3f}" for k, v in splits[key].items())
        rest = ("the body sent and read, its temporary file" if key == "upload" else
                "the body sent and read, its temporary file, the 4 extract batches, the vote")
        print(f"serve: /{key} {t[key]:.3f} s, of which (s, server side) {parts}; the rest "
              f"{t[key] - sum(splits[key].values()):.3f} s ({rest})")
    print(f"serve: 3 segments, 9 variants, views 0/1/2 play pattern_for_view; detect of "
          f"user1's segment 2 matched user1 alone at frequency 1.0, twice at once equal; "
          f"PSNR {psnr:.2f} dB of segment 0 copy 1; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def run_dtcwt_img_path(device, cfg, workdir: Path) -> dict:
    """``cli mark --codec dtcwtImg --wm-image <gray PNG>`` then ``cli detect
    --codec dtcwtImg --out-dir`` on the 48-frame smooth 1920x1080 file of the
    ``dtcwtKey`` phase (the fused masks and delta) and the 1920x804 one of
    the scope phase (the glue and the three syntheses).  Checks the launch
    counts (the same kernels per shape as ``dtcwtKey``), the first batch
    against the same codec under ``plain_kernels()`` on the card (marked u8
    >= 99.5% equal, recovered planes within 1e-4), the PSNR, the 48 PNGs
    the CLI wrote against the planes' unscrambled images and, at 1080p, the
    agreement (> 0.8) of ``degenerate(mean plane, antialias=True)`` with
    the payload image.  Returns the launch counts of the mark and detect
    runs."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.io import read_png_gray, write_png_gray
    from vfp_tpu_torch.wm import BlockShuffler, DeBlockShuffler, DtcwtImg

    n, b, w = cfg["frames"], cfg["b"], cfg["w"]
    batches = -(-n // b)
    rng = np.random.RandomState(19)
    payload = ((rng.rand(27, 48) > 0.5) * 255).astype(np.uint8)
    png = workdir / "payload.png"
    write_png_gray(png, payload)
    codec = DtcwtImg()
    counts = collections.Counter()
    for h in (cfg["h"], cfg["scope_h"]):
        source = workdir / f"smooth_{w}x{h}.rawv"
        out, det = workdir / f"marked_img_{w}x{h}.rawv", workdir / f"img_{w}x{h}"
        flags = ["--codec", "dtcwtImg", "--batch-size", str(b), "--device", str(device)]
        fused = h % 8 == 0
        fresh_counts()
        with NoPlainOnDevice():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark_lines = _cli_lines(cli, ["mark", str(source), str(out), *flags,
                                          "--wm-image", str(png)])
            mark_s = time.perf_counter() - t0
        mark = kernels.launch_counts()
        want = (DTCWT if fused else ("dtcwt_level1_ll_y", "dtcwt_qshift_hp",
                                     "dtcwt_qshift_synthesis", "dtcwt_qshift_synthesis_ll",
                                     "dtcwt_legall_synthesis_ll"))
        assert_counts(mark, {**{k: batches for k in want}, "dtcwt_level1_analysis": 1},
                      f"dtcwtImg mark {h}")
        fresh_counts()
        with NoPlainOnDevice():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det_lines = _cli_lines(cli, ["detect", str(out), *flags, "--out-dir", str(det),
                                         "--wm-height", "27", "--wm-width", "48"])
            det_s = time.perf_counter() - t0
        found = kernels.launch_counts()
        want = ({k: batches for k in DTCWT_DETECT} if fused else
                {"dtcwt_level1_ll_color": batches, "dtcwt_qshift_ll": batches,
                 "dtcwt_qshift_hp": 2 * batches, "dtcwt_legall_synthesis_hp": batches})
        assert_counts(found, want, f"dtcwtImg detect {h}")
        assert f"recovered {n} watermark images" in det_lines, det_lines
        counts.update(mark)
        counts.update(found)

        src, marked = _read_rawv(source), _read_rawv(out)
        assert marked.shape == (n, h, w, 3), marked.shape
        psnr = _psnr(marked, src)
        wm = torch.as_tensor(BlockShuffler(0).generate_wm(payload.astype(np.float32),
                                                          codec.wm_capacity((h, w, 3))),
                             dtype=torch.float32, device=device)
        first = torch.as_tensor(np.array(marked[:b]), device=device)
        with torch.inference_mode():
            planes = torch.cat([codec.extract_frames(torch.as_tensor(np.array(marked[i:i + b]),
                                                                     device=device))
                                for i in range(0, n, b)]).cpu().numpy()
            with plain_kernels():
                want_px = codec.mark_frames(torch.as_tensor(np.array(src[:b]), device=device),
                                            wm).cpu().numpy()
                want_planes = codec.extract_frames(first).cpu().numpy()
        same = float((want_px == marked[:b]).mean())
        plane_err = float(np.abs(planes[:b] - want_planes).max())
        assert same >= 0.995 and plane_err <= 1e-4, (same, plane_err)
        deg = DeBlockShuffler(0).set_shape(payload.shape)
        for i in range(n):
            want_png = np.clip(deg.degenerate(planes[i]), 0, 255).astype(np.uint8)
            assert np.array_equal(read_png_gray(det / f"wm_{i:04d}.png"), want_png), i
        rec = deg.degenerate(planes.mean(0), antialias=True)
        agreement = float(((rec > rec.mean()) == (payload > 127)).mean())
        if h == cfg["h"]:
            assert agreement > 0.8, agreement
        # the JAX DtcwtImg gives about 33 dB on this content too: its alpha 1.5 over
        # the +-255 block watermark, not the port, sets the level
        assert psnr > 30.0, psnr
        print(f"dtcwtimg {w}x{h}: {mark_lines.strip().splitlines()[0]!r}, CLI mark {mark_s:.3f} s "
              f"({n / mark_s:.1f} frames/s), CLI detect --out-dir {det_s:.3f} s "
              f"({n / det_s:.1f} frames/s; host clock around the CLI call, PNG writes "
              f"included); PSNR {psnr:.2f} dB; first batch {same:.6f} of pixels equal to the "
              f"plain kernel path on the card, planes within {plane_err:.3g} (largest "
              f"{float(np.abs(want_planes).max()):.1f}); {n} PNGs equal to the planes' images; "
              f"agreement of the mean plane (antialias) with the payload {agreement:.4f}; "
              f"launches mark { {k: v for k, v in mark.items() if v} }, detect "
              f"{ {k: v for k, v in found.items() if v} }; card "
              f"{nvidia_smi_line()}")
        out.unlink()
    return counts


class StageClock:
    """Seconds spent inside patched functions, summed per stage; ``patch``
    wraps an attribute for the ``with`` block and restores it after."""

    def __init__(self):
        self.s = collections.Counter()
        self._undo = []

    def patch(self, owner, name, stage, sync=False):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                self.s[stage] += time.perf_counter() - t0

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))
        return fn

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


def jpeg_codec_timings(rng, h, w, b) -> str:
    """One 1080p frame's JPEG encode (q90) and decode ms, single-threaded and
    as a batch of ``b`` on the codec's pool, and the pinned digest."""
    import hashlib

    from vfp_tpu_torch.native import jpeg

    frames = natural_frames(rng, b, h, w)
    digest = hashlib.sha256(jpeg.encode_jpeg(
        natural_frames(np.random.RandomState(14), 1, h, w)[0], 90)).hexdigest()
    assert digest == JPEG_1080P_Q90_SHA256, digest
    one = jpeg.encode_jpeg(frames[0], 90)
    assert np.array_equal(jpeg.decode_jpeg(one).shape, (h, w, 3))

    def best(fn, reps=3):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return 1e3 * min(ts)

    enc1 = best(lambda: jpeg.encode_jpeg(frames[0], 90))
    dec1 = best(lambda: jpeg.decode_jpeg(one))
    chunks = jpeg.encode_jpegs(frames, 90)
    encb = best(lambda: jpeg.encode_jpegs(frames, 90))
    decb = best(lambda: jpeg.decode_jpegs(chunks, h, w))
    return (f"JPEG q90 {w}x{h} ({len(one)} bytes): encode {enc1:.2f} ms, decode {dec1:.2f} ms "
            f"a frame on one thread; a batch of {b} on the pool ({jpeg.pool_size()} threads): "
            f"encode {encb:.2f} ms ({encb / b:.2f} a frame), decode {decb:.2f} ms "
            f"({decb / b:.2f} a frame); best of 3, host clock; the digest of the pinned "
            f"frame's JPEG equals the pinned {JPEG_1080P_Q90_SHA256[:16]}...")


def run_durability_path(device, cfg, workdir: Path) -> tuple[dict, Path]:
    """``python -m vfp_tpu_torch.cli durability`` on 180 smooth 1080p frames
    at 30 fps (three 2 s segments of 60): the default codec (``dwtDctSvd``,
    quality 90), ``--codec dct`` and ``--codec dtcwtKey``, each with its
    launch counts zeroed just before and read just after.  The experiment
    writes MJPEG segments at quality 95, marks each segment, writes it at
    quality 90, detects, splices the marked segments by chunk copy,
    re-segments the splice at quality 95 and detects again: 3 JPEG encodes
    and 4 decodes a frame, all on the host in the native codec.  Checks the
    JSON report and the exit code (0 exactly when ``is_successful``), the
    three segment pairs, the bit codecs' and ``dtcwtKey``'s verdicts, and the
    launches counted from the code: marks once per batch of a segment (16
    frames, ``dtcwtKey`` 8, the last batch padded), extracts once per batch
    of a segment in each of the two detect passes, ``dtcwtKey``'s spectrum
    once per segment key.  Prints the wall split into JPEG encode, JPEG
    decode, file I/O and the card's batch calls (the marks' and the bit
    detects' whole calls, the correlation detect's uploads and extracts),
    and the codec's own timings.
    Returns the launch counts of the three runs and the source, a .rawv of
    180 smooth 1080p frames that the media phase codes as its title."""
    import json
    import shutil

    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.io import MjpegAviReader, MjpegAviWriter, RawVideoWriter
    from vfp_tpu_torch.native import NativeRawVideoReader, jpeg
    from vfp_tpu_torch.pipeline import FrameExtractor, FrameMarker
    from vfp_tpu_torch.wm import DtcwtKey
    from vfp_tpu_torch.workflows import durability

    h, w, b = cfg["h"], cfg["w"], cfg["b"]
    n, fps, seg_frames = 180, 30, 60
    segments = n // seg_frames
    root = workdir / "durability"
    root.mkdir()
    rng = np.random.RandomState(14)
    print(f"durability: {jpeg_codec_timings(rng, h, w, b)}; card {nvidia_smi_line()}")
    src = root / "source.rawv"
    with RawVideoWriter(src, w, h, fps=fps) as writer:
        for i in range(0, n, b):
            writer.write_batch(smooth_frames(rng, min(b, n - i), h, w))
    codecs = {"dwtDctSvd": [], "dct": ["--codec", "dct"], "dtcwtKey": ["--codec", "dtcwtKey"]}
    counts = collections.Counter()
    for name, flags in codecs.items():
        out = root / name
        key = name == "dtcwtKey"
        batches = segments * -(-seg_frames // (8 if key else b))  # run_durability_corr: 8
        fresh_counts()
        clock = StageClock()
        with clock, NoPlainOnDevice():
            clock.patch(jpeg, "encode_jpegs", "encode")
            clock.patch(jpeg, "decode_jpegs", "decode")
            clock.patch(MjpegAviReader, "read_batch", "avi read")  # decode included
            clock.patch(MjpegAviWriter, "write_encoded", "file")
            clock.patch(MjpegAviWriter, "close", "file")
            clock.patch(NativeRawVideoReader, "read_batch", "file")
            clock.patch(FrameMarker, "mark", "card")
            clock.patch(FrameExtractor, "extract", "card")
            clock.patch(durability, "upload_batch", "card", sync=True)
            clock.patch(DtcwtKey, "extract_frames", "card", sync=True)  # the correlation detect
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                try:
                    cli(["durability", str(src), str(out), "--device", str(device), *flags])
                    code = 0
                except SystemExit as e:
                    code = e.code
            wall = time.perf_counter() - t0
        found = kernels.launch_counts()
        report = json.loads(text.getvalue())
        assert code == (0 if report["is_successful"] else 1), (name, code)
        assert report["segment_pairs"] == segments and report["original_total"] == segments
        for r in report["original_results"] + report["reencoded_results"]:
            assert r["segment"].endswith(".avi"), r["segment"]
        if name == "dct":
            # the DCT-QIM codec's mark does not survive this channel on this content,
            # in the JAX package as here (PERF.md, PR 14): its verdict is printed, and
            # segment 0 (the all-zero payload) is held on both passes
            assert report["segment_preservation"]["0"]["preserved"], report
        else:
            assert code == 0 and report["is_successful"], (name, report)
            assert report["original_success_rate"] == 1.0, (name, report)
        if key:
            want = {**{k: batches for k in DTCWT[:3]}, "dtcwt_level1_analysis": segments,
                    **{k: 2 * batches for k in DTCWT_DETECT}}
            want["dtcwt_qshift_masks"] = 3 * batches  # the marks' and both detect passes'
        elif name == "dct":
            want = {"fused_dct_qim_mark": batches, "y_dc_mean": batches,
                    "fused_dct_qim_extract": 2 * batches, kernels.EXTRACT_DECIDE: 2 * batches}
        else:
            want = {"fused_mark_planar": batches, "fused_extract_planar": 2 * batches}
        assert_counts(found, want, f"durability {name}")
        counts.update({k: found[k] for k in want})
        s = clock.s
        file_s = s["file"] + s["avi read"] - s["decode"]
        rest = wall - s["encode"] - s["decode"] - file_s - s["card"]
        verdicts = [(p["original_success"], p["reencoded_success"])
                    for p in report["segment_preservation"].values()]
        extra = (f", mean correlations {[round(r['mean_correlation'], 4) for r in report['original_results']]} -> "
                 f"{[round(r['mean_correlation'], 4) for r in report['reencoded_results']]}"
                 if key else "")
        print(f"durability {name}: exit {code}, is_successful {report['is_successful']}, "
              f"original {report['original_success']}/{segments} (avg frequency "
              f"{report['original_avg_frequency']:.4f}), re-encoded "
              f"{report['reencoded_success']}/{segments} (avg frequency "
              f"{report['reencoded_avg_frequency']:.4f}), segments (original, re-encoded) "
              f"{verdicts}{extra}; wall_seconds {report['wall_seconds']:.3f} (CLI {wall:.3f}): "
              f"JPEG encode {s['encode']:.3f}, JPEG decode {s['decode']:.3f}, file I/O "
              f"{file_s:.3f}, the card's batch calls {s['card']:.3f}, the rest {rest:.3f} s; "
              f"{3 * n} encodes and {4 * n} decodes of {w}x{h}; launches "
              f"{ {k: v for k, v in found.items() if v} }; card {nvidia_smi_line()}")
        shutil.rmtree(out)
    return counts, src


def _esds(mp4) -> bytes:
    """An esds box for AAC-LC 44.1 kHz stereo (AudioSpecificConfig 0x1210)."""
    dsi = bytes([0x05, 2, 0x12, 0x10])
    dcd = (bytes([0x04, 13 + len(dsi), 0x40, 0x15, 0, 0x18, 0])
           + struct.pack(">II", 128000, 128000) + dsi)
    sl = bytes([0x06, 1, 0x02])
    es = bytes([0x03, 3 + len(dcd) + len(sl), 0, 1, 0]) + dcd + sl
    return mp4._full(b"esds", 0, 0, es)


def mp4a_stsd(mp4, rate: int = AUDIO_RATE, channels: int = 2) -> bytes:
    """The stsd box of one ``mp4a`` AudioSampleEntry with its esds."""
    body = (b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 8
            + struct.pack(">HHHH", channels, 16, 0, 0) + struct.pack(">I", rate << 16)
            + _esds(mp4))
    entry = struct.pack(">I4s", 8 + len(body), b"mp4a") + body
    return mp4._full(b"stsd", 0, 0, struct.pack(">I", 1) + entry)


def audio_payloads(seconds: float, seed: int = 0) -> list:
    """Seeded AAC-sized sample bytes, one 1024-sample frame at 44.1 kHz each:
    the media layer never decodes audio, so random bytes exercise it fully."""
    rng = np.random.RandomState(seed)
    n = int(np.ceil(seconds * AUDIO_RATE / 1024))
    return [rng.bytes(int(rng.randint(180, 420))) for _ in range(n)]


def audio_track(mp4, payloads):
    """A ``soun`` track of inline samples, built through ``mp4``'s Track (the
    port's ``vfp_tpu_torch.io.mp4``, or the JAX package's in the tests)."""
    tr = mp4.Track(handler=b"soun", timescale=AUDIO_RATE, stsd=mp4a_stsd(mp4), volume=0x0100)
    for p in payloads:
        tr.samples.append(mp4.Sample(src=None, offset=0, size=len(p), duration=1024, data=p))
    return tr


def sample_bytes(track) -> bytes:
    """A track's sample bytes in order, read from their files."""
    out = []
    for s in track.samples:
        if s.data is not None:
            out.append(s.data)
            continue
        with open(s.src, "rb") as f:
            f.seek(s.offset)
            out.append(f.read(s.size))
    return b"".join(out)


def y4m_frames(h: int, w: int) -> np.ndarray:
    """The media phase's ``.y4m`` content: ``MEDIA["y4m_frames"]`` smooth
    frames of their own seed (the CPU tests run the JAX CLI on these)."""
    return smooth_frames(np.random.RandomState(MEDIA["y4m_seed"]), MEDIA["y4m_frames"], h, w)


def run_media_path(device, cfg, workdir: Path, frames_rawv: Path) -> dict:
    """The ffmpeg-free media layer through the CLI on the card.  Source: the
    durability phase's 180 ``smooth_frames`` of 1920x1080 at 30 fps
    (``frames_rawv``), JPEG-coded by the port at q95 into an MJPEG ``.avi``
    and remuxed with 6 s of synthetic AAC-sized audio into an ``.mp4``
    (``io/mp4.py``).  (The grainy ``natural_frames`` lose the flagship mark
    to the q95 JPEG of the variants, in the JAX package as here:
    tests/test_torch_media_workflow.py shows it at 1080p.)  Then
    ``hls-mark --copies 3``:
    three 2 s MJPEG ``.avi`` segments with audio sidecars, 9 variants with
    theirs, every one verified; ``leak --pattern 201`` -> ``leaked_video.mp4``
    (the variants' JPEG chunks and the sidecars' audio remuxed, no decode),
    whose audio sample bytes must equal the source's; ``trace`` with the
    manifests -> ``Copy fingerprint: 201`` on 100% of segments.  The launches
    are counted from the code: 3 segments x 4 batches x 3 variants of marks,
    verify packs 540 frames into 34 extract batches, trace 180 into 12.  Then
    ``mark`` of a 16-frame 1080p ``.y4m`` (``y4m_frames``) into a ``.y4m`` ->
    ``detect --payload``, which must recover it, with its own counts.  Prints the wall
    split (JPEG encode, JPEG decode, box mux, ``mark_segments``, trace, the
    card's batch calls, y4m planes) and the card.  Returns the launch counts."""
    import shutil

    from vfp_tpu_torch import fingerprint, kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.io import MjpegAviWriter, Y4MWriter, mp4, y4m
    from vfp_tpu_torch.native import jpeg
    from vfp_tpu_torch.pipeline import FrameExtractor, MultiMarker

    h, w, b = cfg["h"], cfg["w"], cfg["b"]
    n, fps, copies, seg_frames = MEDIA["n"], MEDIA["fps"], MEDIA["copies"], MEDIA["seg_frames"]
    segments, pattern, seg_s = n // seg_frames, MEDIA["pattern"], seg_frames / fps
    root = workdir / "media"
    root.mkdir()
    flags = ["--batch-size", str(b), "--device", str(device)]
    clock = StageClock()
    with clock:
        clock.patch(jpeg, "encode_jpegs", "encode")
        clock.patch(jpeg, "decode_jpegs", "decode")
        clock.patch(mp4, "write_mp4", "box mux")
        clock.patch(fingerprint, "mark_segments", "mark_segments")
        for cls in (MultiMarker, FrameExtractor):
            clock.patch(cls, "submit", "card")
            clock.patch(cls, "collect", "card")
        t0 = time.perf_counter()
        avi = root / "source.avi"
        frames = _read_rawv(frames_rawv)
        assert frames.shape == (n, h, w, 3), frames.shape
        with MjpegAviWriter(avi, w, h, fps, MEDIA["quality"]) as writer:
            for i in range(0, n, b):
                writer.write_batch(frames[i: i + b])
        del frames
        audio = audio_payloads(MEDIA["audio_s"], seed=16)
        src = root / "source.mp4"
        mp4.write_mp4(src, [mp4.track_from_mjpeg_avi(avi), audio_track(mp4, audio)])
        avi.unlink()
        build_s = time.perf_counter() - t0
        source_split = dict(clock.s)
        clock.s.clear()

        out = root / "out"
        fresh_counts()
        walls = {}
        with NoPlainOnDevice():
            t0 = time.perf_counter()
            text = _cli_lines(cli, ["hls-mark", str(src), str(out), "--copies", str(copies),
                                    "--segment-duration", str(seg_s), *flags])
            walls["hls-mark"] = time.perf_counter() - t0
            assert f"created {segments} segments" in text, text
            assert "All segments were watermarked successfully!" in text, text
            names = {p.name for p in (out / "segments").iterdir()}
            assert names == {f"segment_{i:03d}{ext}" for i in range(segments)
                             for ext in (".avi", ".audio.mp4")}, names
            hls_names = {p.name for p in (out / "hls").iterdir()}
            assert all(f"marked_seg{i:03d}_copy{c}{ext}" in hls_names for i in range(segments)
                       for c in range(copies) for ext in (".avi", ".audio.mp4")), hls_names
            t0 = time.perf_counter()
            text = _cli_lines(cli, ["leak", str(out / "segment_copies.json"), "--pattern",
                                    pattern, *flags[2:]])
            walls["leak"] = time.perf_counter() - t0
            leaked = out / "leaked_video.mp4"
            assert f"leaked video: {leaked}" in text, text
            leak = mp4.read_mp4(leaked)
            assert leak.video().codec_fourcc() == b"jpeg" and len(leak.video().samples) == n
            audio_equal = sample_bytes(leak.audio()) == b"".join(audio)
            assert audio_equal, "the leak's audio differs from the source's"
            t0 = time.perf_counter()
            text = _cli_lines(cli, ["trace", str(leaked), str(root / "det"), "--payload-file",
                                    str(out / "segment_payloads.json"), "--max-copies",
                                    str(copies), "--segment-duration", str(seg_s), *flags[2:]])
            walls["trace"] = time.perf_counter() - t0
            assert f"Copy fingerprint: {pattern}" in text, text
            assert "Success rate: 100.00%" in text, text
        found = kernels.launch_counts()
        n_variants = copies * n
        want = {"fused_mark_planar": segments * -(-seg_frames // b) * copies,
                "fused_extract_planar": -(-n_variants // b) + -(-n // b)}
        assert_counts(found, want, "media")
        counts = collections.Counter({k: found[k] for k in want})
        split = dict(clock.s)
        clock.s.clear()
        shutil.rmtree(out)
        shutil.rmtree(root / "det")

        # a .y4m round trip at 1080p: 4:2:0 planes in and out, the flagship codec between
        clock.patch(y4m, "_y4m_planes_to_rgb", "y4m planes")
        clock.patch(y4m, "_rgb_to_y4m_planes", "y4m planes")
        k = MEDIA["y4m_frames"]
        y4m_in, y4m_out = root / "in.y4m", root / "out.y4m"
        with Y4MWriter(y4m_in, w, h, fps) as writer:
            writer.write_batch(y4m_frames(h, w))
        fresh_counts()
        with NoPlainOnDevice():
            t0 = time.perf_counter()
            text = _cli_lines(cli, ["mark", str(y4m_in), str(y4m_out), *flags])
            assert f"marked {k} frames" in text, text
            text = _cli_lines(cli, ["detect", str(y4m_out), "--payload", PAYLOAD, *flags])
            walls["y4m"] = time.perf_counter() - t0
        assert f"majority payload: {PAYLOAD}" in text, text
        y4m_found = kernels.launch_counts()
        y4m_want = {"fused_mark_planar": -(-k // b), "fused_extract_planar": -(-k // b)}
        assert_counts(y4m_found, y4m_want, "media y4m")
        counts.update({kk: y4m_found[kk] for kk in y4m_want})
        y4m_planes = clock.s["y4m planes"]
    shutil.rmtree(root)
    print(f"media: source {n} frames of {w}x{h} at {fps} fps (the durability source) -> "
          f"MJPEG q{MEDIA['quality']} .mp4 "
          f"with {len(audio)} audio samples in {build_s:.3f} s (JPEG encode "
          f"{source_split['encode']:.3f}, box mux {source_split['box mux']:.3f} s); card "
          f"{nvidia_smi_line()}")
    print(f"media: hls-mark {walls['hls-mark']:.3f} s (mark_segments "
          f"{split['mark_segments']:.3f} s), leak {walls['leak']:.3f} s, trace "
          f"{walls['trace']:.3f} s (CLI walls); summed over threads: JPEG encode "
          f"{split['encode']:.3f} s, JPEG decode {split['decode']:.3f} s, box mux "
          f"{split['box mux']:.3f} s, the card's batch calls (submit + collect, host clock) "
          f"{split['card']:.3f} s; Copy fingerprint {pattern}, 100% of "
          f"{segments} segments verified x{copies} and traced; the leak's audio equals the "
          f"source's: {audio_equal}; launches {dict(counts)}; card {nvidia_smi_line()}")
    print(f"media: y4m {k} frames of {w}x{h}: cli mark .y4m -> .y4m -> detect "
          f"{walls['y4m']:.3f} s (y4m planes {y4m_planes:.3f} s), payload {PAYLOAD} "
          f"recovered; launches {y4m_want}; card {nvidia_smi_line()}")
    return counts


FFMPEG_SHIM = "ffmpeg: shim (tests/ffmpeg_shim, VFPRAWV1 bytes under .mp4/.m4s names; no H.264)"


def _same_frames(a: Path, b: Path) -> bool:
    """Whether two VFPRAWV1 files hold the same frame bytes (after their
    24-byte headers), compared through memory maps."""
    x, y = (np.memmap(p, np.uint8, "r", offset=24) for p in (a, b))
    return x.shape == y.shape and bool(np.array_equal(x, y))


def _first_frames(path: Path, k: int) -> np.ndarray:
    from vfp_tpu_torch.io import RawVideoReader

    r = RawVideoReader(path)
    try:
        return r.read_batch(k)
    finally:
        r.close()


def run_ffmpeg_path(device, cfg, workdir: Path, hls_counts: dict) -> dict:
    """The ffmpeg route (``io/ffmpeg.py``) through the CLI on the card, with
    ``tests/ffmpeg_shim`` first on PATH: a fake ``ffmpeg``/``ffprobe`` pair
    over the VFPRAWV1 container that copies frame bytes under ``.mp4`` and
    ``.m4s`` names (no H.264; it exits 2 on any argv the real calls do not
    use).  ``have_ffmpeg`` is cached and the CLI runs in this process, so the
    cache is cleared when the shim goes onto PATH and again when PATH is
    restored, and the phase ends by asserting that it is False again.  On the
    hls phase's 180 1080p frames at 30 fps: ``hls-mark --copies 3`` -> 3
    ``.mp4`` segments (ffmpeg's segmenter), 9 ``.mp4`` variants (the pipe
    writer), 9 ``.m4s`` (ffmpeg's remux), each variant's frames byte-equal
    to the hls phase's ``.rawv`` variant (the shim is lossless, so the marks
    must be the same) and its first batch equal to the plain version; then
    ``leak --pattern 201`` -> ``leaked_video.mp4`` (ffmpeg's concat) ->
    ``trace`` with the manifests (``201``), whose launches must equal the
    hls phase's for the same commands (its second, blind trace left out):
    the route changes containers, not batches.  Then ``mark`` of a 48-frame 1080p
    ``.rawv`` into an ``.mp4`` -> ``detect`` of the ``.mp4`` (48/48).
    Prints the walls (segmenting, ``mark_segments``, m4s mux, leak, trace,
    pipe reads and writes) with the card.  Returns the launch counts."""
    import shutil

    from vfp_tpu_torch import fingerprint, kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.fingerprint import hls as thls, payload_for_segment
    from vfp_tpu_torch.io import RawVideoWriter, ffmpeg
    from vfp_tpu_torch.kernels.fused_embed import fused_mark_planar_reference
    from vfp_tpu_torch.wm import DwtDctSvd, Shuffler, block_grid

    h, w, b = cfg["h"], cfg["w"], cfg["b"]
    n, copies, seg_frames = HLS["n"], HLS["copies"], HLS["seg_frames"]
    segments = n // seg_frames
    src = workdir / "hls" / "source.rawv"  # the hls phase's source and .rawv variants
    ref = workdir / "hls" / "out" / "marked_segments"
    root = workdir / "ffmpeg"
    root.mkdir()
    out = root / "out"
    flags = ["--batch-size", str(b), "--device", str(device)]
    shim = ROOT / "tests" / "ffmpeg_shim"
    assert all(os.access(shim / name, os.X_OK) for name in ("ffmpeg", "ffprobe")), shim
    path = os.environ["PATH"]
    os.environ["PATH"] = f"{shim}{os.pathsep}{path}"
    ffmpeg.have_ffmpeg.cache_clear()
    print(FFMPEG_SHIM)
    walls, clock, t_phase = {}, StageClock(), time.perf_counter()
    try:
        assert ffmpeg.have_ffmpeg(), "the shim is not on PATH"
        with clock:
            clock.patch(ffmpeg, "segment_video_ffmpeg", "segmenting")
            clock.patch(fingerprint, "mark_segments", "mark_segments")
            clock.patch(thls, "mux_variant_to_m4s", "m4s mux")
            clock.patch(ffmpeg.FFmpegPipeReader, "read_batch", "pipe read")
            for name in ("write_batch", "close"):
                clock.patch(ffmpeg.FFmpegPipeWriter, name, "pipe write")
            fresh_counts()
            with NoPlainOnDevice():
                t0 = time.perf_counter()
                text = _cli_lines(cli, ["hls-mark", str(src), str(out), "--copies",
                                        str(copies), *flags])
                walls["hls-mark"] = time.perf_counter() - t0
                mark_split = dict(clock.s)
                assert f"created {segments} segments" in text, text
                assert "All segments were watermarked successfully!" in text, text
                names = sorted(p.name for p in (out / "segments").iterdir())
                assert names == [f"segment_{i:03d}.mp4" for i in range(segments)], names
                variants = [(i, c) for i in range(segments) for c in range(copies)]
                names = sorted(p.name for p in (out / "marked_segments").iterdir())
                assert names == sorted(f"marked_seg{i}_copy{c}.mp4" for i, c in variants), names
                m4s = sorted((out / "hls").glob("*.m4s"))
                assert len(m4s) == len(variants), m4s
                assert (json.loads((out / "segment_payloads.json").read_text())
                        == json.loads((ref.parent / "segment_payloads.json").read_text()))
                for i, c in variants:  # the shim is lossless: the .rawv route's marks
                    assert _same_frames(out / "marked_segments" / f"marked_seg{i}_copy{c}.mp4",
                                        ref / f"marked_seg{i}_copy{c}.rawv"), \
                        ("variant differs from the .rawv route's", i, c)
                first_source = _first_frames(out / "segments" / "segment_000.mp4", b)
                first_marked = _first_frames(out / "marked_segments" / "marked_seg0_copy1.mp4", b)
                for p in (out / "segments", out / "hls"):  # the leak needs neither
                    shutil.rmtree(p)
                leaked = out / "leaked_video.mp4"
                t0 = time.perf_counter()
                text = _cli_lines(cli, ["leak", str(out / "segment_copies.json"), "--pattern",
                                        "201", *flags[2:]])
                walls["leak"] = time.perf_counter() - t0
                assert f"leaked video: {leaked}" in text and "pattern: 201" in text, text
                t0 = time.perf_counter()
                text = _cli_lines(cli, ["trace", str(leaked), str(root / "det"), "--payload-file",
                                        str(out / "segment_payloads.json"), "--max-copies",
                                        str(copies), *flags[2:]])
                walls["trace"] = time.perf_counter() - t0
                assert "Copy fingerprint: 201" in text, text
                assert "Success rate: 100.00%" in text, text
                assert sorted(p.suffix for p in (root / "det" / "segments").iterdir()) == \
                    [".mp4"] * segments
            found = kernels.launch_counts()
            # the hls phase's batches, less its second (blind) trace of n frames
            want = dict(hls_counts)
            want["fused_extract_planar"] -= -(-n // b)
            assert_counts(found, want, "ffmpeg")
            counts = collections.Counter(want)
            hls_split = dict(clock.s)
            clock.s.clear()

            # mark a 48-frame 1080p .rawv into an .mp4 through the pipe, detect the .mp4
            k = cfg["frames"]
            mp4_in, mp4_out = root / "in.rawv", root / "out.mp4"
            _write_rawv(mp4_in, np.random.RandomState(17), k, h, w)
            fresh_counts()
            with NoPlainOnDevice():
                t0 = time.perf_counter()
                text = _cli_lines(cli, ["mark", str(mp4_in), str(mp4_out), *flags])
                assert f"marked {k} frames" in text, text
                text = _cli_lines(cli, ["detect", str(mp4_out), "--payload", PAYLOAD, *flags])
                walls["mark/detect .mp4"] = time.perf_counter() - t0
            assert f"frames: {k} " in text, text
            assert f"majority payload: {PAYLOAD} (frequency 1.00)" in text, text  # 48/48
            mp4_found = kernels.launch_counts()
            mp4_want = {"fused_mark_planar": -(-k // b), "fused_extract_planar": -(-k // b)}
            assert_counts(mp4_found, mp4_want, "ffmpeg mark/detect .mp4")
            counts.update(mp4_want)
            mp4_split = dict(clock.s)
            clock.s.clear()

            # cli durability through the shim: ffmpeg's segments, the pipe writer's
            # marked .mp4, ffmpeg's concat into full.mp4 and its re-segmenting
            dur_n, dur_segs = DURABILITY_FFMPEG["n"], DURABILITY_FFMPEG["segments"]
            dur_in, dur_out = root / "dur_in.rawv", root / "dur"
            with RawVideoWriter(dur_in, w, h, fps=HLS["fps"]) as writer:
                rng = np.random.RandomState(18)
                for i in range(0, dur_n, b):
                    writer.write_batch(natural_frames(rng, min(b, dur_n - i), h, w))
            fresh_counts()
            with NoPlainOnDevice():
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    try:
                        cli(["durability", str(dur_in), str(dur_out), "--segment-duration", "1",
                             "--device", str(device)])
                        code = 0
                    except SystemExit as e:
                        code = e.code
                walls["durability"] = time.perf_counter() - t0
            report = json.loads(text.getvalue())
            assert code == 0 and report["is_successful"], (code, report)
            assert report["segment_pairs"] == report["original_total"] == dur_segs, report
            assert report["original_success_rate"] == report["reencoded_success_rate"] == 1.0
            for r in report["original_results"] + report["reencoded_results"]:
                assert r["segment"].endswith(".mp4"), r["segment"]
            assert (dur_out / "full.mp4").exists()
            assert sorted(p.name for p in (dur_out / "marked_segments").iterdir()) == [
                f"marked_segment_{i:03d}.mp4" for i in range(dur_segs)]
            dur_batches = dur_segs * -(-(dur_n // dur_segs) // 16)  # run_durability's batch
            dur_want = {"fused_mark_planar": dur_batches, "fused_extract_planar": 2 * dur_batches}
            assert_counts(kernels.launch_counts(), dur_want, "ffmpeg durability")
            counts.update(dur_want)
            dur_split = dict(clock.s)
            shutil.rmtree(dur_out)
            dur_in.unlink()
    finally:
        os.environ["PATH"] = path
        ffmpeg.have_ffmpeg.cache_clear()
    assert not ffmpeg.have_ffmpeg(), "ffmpeg still resolves after the phase"

    codec = DwtDctSvd()
    wm = Shuffler(key=0).generate_wm(payload_for_segment(0, 1), codec.wm_capacity((h, w, 3)))
    (nbh, nbw), _ = block_grid((h, w))
    wm2d = torch.as_tensor(np.asarray(wm, np.float32).reshape(-1)[: nbh * nbw].reshape(nbh, nbw),
                           device=device)
    x = torch.as_tensor(first_source, device=device).permute(0, 3, 1, 2)
    want_px = fused_mark_planar_reference(x, wm2d, 15.0, 1).permute(0, 2, 3, 1).cpu().numpy()
    same = float((want_px == first_marked).mean())
    assert same >= 0.995, same
    shutil.rmtree(root)
    card = nvidia_smi_line()
    print(f"ffmpeg: hls-mark {n} frames of {w}x{h} at {HLS['fps']} fps, {copies} copies "
          f"through the shim: {walls['hls-mark']:.3f} s CLI wall; summed over threads: "
          f"segmenting {mark_split['segmenting']:.3f} s, mark_segments "
          f"{mark_split['mark_segments']:.3f} s, m4s mux {mark_split['m4s mux']:.3f} s, pipe "
          f"read {mark_split['pipe read']:.3f} s, pipe write {mark_split['pipe write']:.3f} s; "
          f"{segments} .mp4 segments, {len(variants)} .mp4 variants byte-equal in frames to "
          f"the hls phase's .rawv variants, {len(variants)} .m4s; {same:.6f} of segment 0 "
          f"copy 1's first batch equal to the plain version; card {card}")
    print(f"ffmpeg: leak 201 {walls['leak']:.3f} s (ffmpeg concat -> leaked_video.mp4), trace "
          f"with the manifests {walls['trace']:.3f} s (CLI walls, ffmpeg re-segmenting "
          f"included); Copy fingerprint 201, 100% success; the whole workflow's pipe read "
          f"{hls_split['pipe read']:.3f} s, pipe write {hls_split['pipe write']:.3f} s, "
          f"segmenting {hls_split['segmenting']:.3f} s; launches {want} equal to the hls "
          f"phase's hls-mark and trace 201; the phase {time.perf_counter() - t_phase:.1f} s; "
          f"card {card}")
    print(f"ffmpeg: mark {k} frames of {w}x{h} .rawv -> .mp4 (pipe writer) -> detect .mp4 "
          f"(pipe reader): {walls['mark/detect .mp4']:.3f} s, payload {PAYLOAD} in {k}/{k} "
          f"frames; pipe read {mp4_split['pipe read']:.3f} s, write "
          f"{mp4_split['pipe write']:.3f} s; launches {mp4_want}; card {card}")
    print(f"ffmpeg: cli durability of {dur_n} frames of {w}x{h} at {HLS['fps']} fps, 1 s "
          f"segments, through the shim (it copies frames: this proves the plumbing, not "
          f"libx264's loss): {dur_segs} .mp4 segments by ffmpeg's segmenter, marked .mp4 by "
          f"the pipe writer, full.mp4 by ffmpeg's concat, re-segmented by ffmpeg; original "
          f"{report['original_success']}/{dur_segs}, re-encoded "
          f"{report['reencoded_success']}/{dur_segs}, is_successful True, exit 0; "
          f"{walls['durability']:.3f} s CLI wall (segmenting {dur_split['segmenting']:.3f} s, "
          f"pipe read {dur_split['pipe read']:.3f} s, pipe write {dur_split['pipe write']:.3f} "
          f"s); launches {dur_want}, counted apart from the phase's others; card {card}")
    return counts


def _bytes_mb(n: int) -> str:
    return f"{n / 1e6:.1f} MB"


def run_lowlink_path(device, cfg, workdir: Path, source_1080p: Path, hls_stats: dict) -> dict:
    """The LL-domain transport (``pipeline/lowlink.py``) on the card, with
    ``VFP_LOWLINK=1`` set in this process for the phase and the environment
    restored after it (``use_lowlink`` off again).  1. ``cli mark`` ->
    ``detect --payload`` of the main path's 48-frame 1920x1080 .rawv once per
    wire (``u8``, ``f16``): 48/48 payloads, PSNR > 40 dB, the share of
    pixels within +-1 of the main path's full-frame file printed,
    ``qim_triplet_soa`` once a mark batch (the per-variant delta of one
    variant) and ``qim_decode_soa`` once a detect batch, no fused kernel.
    2. ``hls-mark --copies 3`` of the hls phase's 180 frames on the u8 wire
    (the two planes, packed across segments by one ``PackedTwoPlane``) ->
    ``leak --pattern 201`` -> ``trace`` with the manifests: every variant
    verified, the fingerprint on 100% of segments, ``qim_triplet_soa``
    launched once per packed call, those calls' frames summing to 180 (how
    many calls depends on when the writer's collects overtake the submits),
    no batch routed to the host by the flat-content hysteresis,
    ``qim_decode_soa`` once per 16 frames of verify (540) and trace (180).
    3. ``VFP_LL_WIRE=host``: one 16-frame 1080p mark -> detect with no launch
    and ``torch.cuda.memory_allocated()`` unchanged.  4. On the host clock
    (median of 5 after a warm-up), one 16-frame 1080p batch with 3 variants:
    ``MultiMarker.mark_all`` full-frame vs the u8 (and f16) wire with the
    wire's stage split, ``FrameExtractor.extract`` both ways, and the bytes
    each leg moves; the hls-mark walls of both paths (``mark_segments``'
    wall_seconds; the full-frame one from the hls phase).  Returns the
    launch counts of 1 and 2."""
    import ast
    import shutil

    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.fingerprint import payload_for_segment
    from vfp_tpu_torch.pipeline import FrameExtractor, FrameMarker, MultiMarker, use_lowlink
    from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd, Shuffler

    h, w, b, n = cfg["h"], cfg["w"], cfg["b"], cfg["frames"]
    batches = -(-n // b)
    root = workdir / "lowlink"
    root.mkdir()
    saved = {k: os.environ.get(k) for k in ("VFP_LOWLINK", "VFP_LL_WIRE")}
    card = nvidia_smi_line()
    counts = collections.Counter()
    t_phase = time.perf_counter()
    try:
        os.environ["VFP_LOWLINK"] = "1"
        flags = ["--batch-size", str(b), "--device", str(device)]
        src = _read_rawv(source_1080p)
        full = _read_rawv(workdir / f"marked_{w}x{h}.rawv")  # the main path's full-frame file
        for wire in ("u8", "f16"):
            os.environ["VFP_LL_WIRE"] = wire
            out = root / f"marked_{wire}.rawv"
            fresh_counts()
            with NoPlainOnDevice():
                t0 = time.perf_counter()
                text = _cli_lines(cli, ["mark", str(source_1080p), str(out), *flags])
                t_mark = time.perf_counter() - t0
                assert f"marked {n} frames" in text, text
                text = _cli_lines(cli, ["detect", str(out), "--payload", PAYLOAD, *flags])
            assert f"majority payload: {PAYLOAD} (frequency 1.00)" in text, text  # 48/48
            found = kernels.launch_counts()
            want = {"qim_triplet_soa": batches, "qim_decode_soa": batches}
            assert_counts(found, want, f"lowlink {wire} mark/detect")
            assert found["fused_mark_planar"] == found["fused_extract_planar"] == 0
            counts.update(want)
            marked = _read_rawv(out)
            assert marked.shape == src.shape, marked.shape
            psnr = _psnr(marked, src)
            assert psnr > 40.0, psnr
            d = np.abs(marked.astype(np.int16) - full.astype(np.int16))
            print(f"lowlink {wire}: cli mark -> detect of {n} frames of {w}x{h}: payload "
                  f"{PAYLOAD} in {n}/{n} frames, PSNR {psnr:.2f} dB vs source; vs the full-frame "
                  f"path's marked file: {float((d == 0).mean()):.6f} of pixels equal, "
                  f"{float((d <= 1).mean()):.6f} within +-1, max {int(d.max())}; mark CLI "
                  f"{t_mark:.3f} s; launches {want}; card {card}")
            out.unlink()
        del src, full, marked, d

        # 2. the HLS workflow on the u8 wire, packed
        os.environ["VFP_LL_WIRE"] = "u8"
        hls_src = workdir / "hls" / "source.rawv"
        out = root / "hls"
        n_hls, copies, seg_frames = HLS["n"], HLS["copies"], HLS["seg_frames"]
        fresh_counts()
        with NoPlainOnDevice():
            t0 = time.perf_counter()
            text = _cli_lines(cli, ["hls-mark", str(hls_src), str(out), "--copies", str(copies),
                                    *flags])
            t_hls = time.perf_counter() - t0
            assert f"created {n_hls // seg_frames} segments" in text, text
            assert "All segments were watermarked successfully!" in text, text
            stats = ast.literal_eval(text.split("mark_segments stats: ", 1)[1].splitlines()[0])
            marks = kernels.launch_counts()
            for p in (out / "segments", out / "hls"):  # the leak needs neither
                shutil.rmtree(p)
            leaked = root / "leak_201.rawv"
            text = _cli_lines(cli, ["leak", str(out / "segment_copies.json"), "--pattern",
                                    "201", "--output-file", str(leaked), *flags[2:]])
            assert "pattern: 201" in text, text
            text = _cli_lines(cli, ["trace", str(leaked), str(root / "det"), "--payload-file",
                                    str(out / "segment_payloads.json"), "--max-copies",
                                    str(copies), *flags[2:]])
            assert "Copy fingerprint: 201" in text and "Success rate: 100.00%" in text, text
        found = kernels.launch_counts()
        calls = stats["packed_device_calls"]
        assert stats["packed_device_frames"] == n_hls, stats
        assert stats["host_routed_batches"] == 0, stats
        # verify packs the variants' frames b a batch, trace decodes 16 a batch
        want = {"qim_triplet_soa": calls,
                "qim_decode_soa": -(-copies * n_hls // b) + -(-n_hls // 16)}
        assert marks["qim_triplet_soa"] == calls, (marks, stats)
        assert_counts(found, want, "lowlink hls")
        counts.update(want)
        shutil.rmtree(out)
        shutil.rmtree(root / "det")
        leaked.unlink()
        ss = stats["stage_seconds"]
        print(f"lowlink hls: hls-mark {n_hls} frames of {w}x{h}, {copies} copies on the u8 wire: "
              f"CLI {t_hls:.3f} s, mark_segments wall {stats['wall_seconds']} s (the hls phase's "
              f"full-frame run: {hls_stats['wall_seconds']} s); {calls} packed device calls for "
              f"{stats['packed_device_frames']} frames, {stats['host_routed_batches']} batches "
              f"routed to the host; stages {ss}; host busy {stats['host_busy_seconds']} s, "
              f"link/device wait {stats['link_device_wait_seconds']} s; leak 201 -> trace: "
              f"Copy fingerprint 201, 100% success; launches {want}; card {card}")

        # 3. the host wire: no launch, no device memory
        os.environ["VFP_LL_WIRE"] = "host"
        rng = np.random.RandomState(19)
        frames = natural_frames(rng, b, h, w)
        codec = DwtDctSvd()
        wm = Shuffler(key=0).generate_wm(np.array([int(c) for c in PAYLOAD]),
                                         codec.wm_capacity((h, w, 3)))
        deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        fresh_counts()
        t0 = time.perf_counter()
        marked = FrameMarker(codec, wm, b, device=device).mark(frames)
        payloads = FrameExtractor(codec, deg, b, device=device).extract(marked)
        t_host = time.perf_counter() - t0
        assert not any(kernels.launch_counts().values()), kernels.launch_counts()
        assert torch.cuda.memory_allocated() == mem, (mem, torch.cuda.memory_allocated())
        assert (payloads == np.array([int(c) for c in PAYLOAD], np.uint8)).all(), payloads
        print(f"lowlink host wire: mark -> detect of {b} frames of {w}x{h} on the host: "
              f"{t_host:.3f} s, 0 launches, device memory unchanged ({mem} B), payload "
              f"{PAYLOAD} in {b}/{b}")

        # 4. timings on the host clock
        wms = [Shuffler(key=0).generate_wm(payload_for_segment(0, c),
                                           codec.wm_capacity((h, w, 3))) for c in range(3)]
        frame_b = b * h * w * 3
        ll_px = b * (h // 4 * 2) * (w // 4 * 2)
        legs = {"full": (frame_b, 3 * frame_b), "u8": (ll_px, 2 * ll_px),
                "f16": (2 * ll_px, 2 * ll_px)}
        rows = []
        for path in ("full", "u8", "f16"):
            os.environ["VFP_LOWLINK"] = "0" if path == "full" else "1"
            os.environ["VFP_LL_WIRE"] = "u8" if path == "full" else path
            mm = MultiMarker(codec, wms, b, device=device)
            assert (mm._ll is None) == (path == "full")
            mm.mark_all(frames)  # warm-up
            if mm._ll is not None:
                for k in mm._ll.stage_seconds:
                    mm._ll.stage_seconds[k] = 0.0
            ms = _median_ms(lambda: mm.mark_all(frames))
            split = ("" if mm._ll is None else "; stages per call " + ", ".join(
                f"{k} {v / 6 * 1e3:.2f} ms" for k, v in mm._ll.stage_seconds.items()))
            up, down = legs[path]
            rows.append(f"MultiMarker.mark_all {path}: {ms:.2f} ms ({b / ms * 1e3:.1f} frames/s), "
                        f"up {_bytes_mb(up)}, down {_bytes_mb(down)}{split}")
        for path in ("full", "u8"):
            os.environ["VFP_LOWLINK"] = "0" if path == "full" else "1"
            os.environ["VFP_LL_WIRE"] = "u8"
            fx = FrameExtractor(codec, deg, b, device=device)
            ms = _median_ms(lambda: fx.extract(marked))
            up = frame_b if path == "full" else ll_px
            rows.append(f"FrameExtractor.extract {path}: {ms:.2f} ms ({b / ms * 1e3:.1f} "
                        f"frames/s), up {_bytes_mb(up)}, down {b * len(PAYLOAD)} B")
        for row in rows:
            print(f"lowlink timing ({b} frames of {w}x{h}, 3 variants, host clock, median of "
                  f"5): {row}; card {card}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(root)
    assert not use_lowlink(DwtDctSvd()), "the transport is still on after the phase"
    print(f"lowlink: the phase {time.perf_counter() - t_phase:.1f} s; use_lowlink off again; "
          f"launches {dict(counts)}")
    return counts


def check_int_kernels(device, cfg, rng) -> dict:
    """The flagship kernels' integer bodies against their plain versions,
    ``torch.equal``: 1080p B=16 on the interleaved view (16-byte staging), a
    1916-wide batch (W % 16 != 0: 4-byte staging), a contiguous planar
    batch (bytes through the strides), 1078 rows (rows past the block grid,
    which must pass through) and all-0 and all-255 frames (the epilogue's
    clamps).  Returns {name: max abs error}."""
    from vfp_tpu_torch.kernels import EXTRACT_INT, MARK_INT
    from vfp_tpu_torch.kernels import fused_embed as fe
    from vfp_tpu_torch.wm import DwtDctSvd, block_grid

    codec = DwtDctSvd(int_path=True)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    cases = [("interleaved", b, h, w), ("W % 16 != 0", 2, h, cfg["int_w"]),
             ("planar", 2, h, w), ("rows past the grid", 2, cfg["tail_h"], w),
             ("all 0", 2, h, w), ("all 255", 2, h, w)]
    err = {MARK_INT: 0.0, EXTRACT_INT: 0.0}
    for label, fb, fh, fw in cases:
        frames = natural_frames(rng, fb, fh, fw)
        if label.startswith("all"):
            frames[:] = int(label.split()[1])
        planes = torch.as_tensor(frames, device=device).permute(0, 3, 1, 2)
        if label == "planar":
            planes = planes.contiguous()
        (nbh, nbw), _ = block_grid((fh, fw))
        wm2d = spread_wm(codec, fh, fw, device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
        got = fe.fused_mark_planar(planes, wm2d, 15.0, 1, int_path=True)
        torch.cuda.synchronize()
        want = fe.fused_mark_planar_reference(planes, wm2d, 15.0, 1, int_path=True)
        err[MARK_INT] = max(err[MARK_INT], float((got.int() - want.int()).abs().max()))
        assert torch.equal(got, want), f"int mark {label} {fb}x{fh}x{fw}"
        assert torch.equal(got[:, :, 8 * nbh:], planes[:, :, 8 * nbh:]), "rows past the grid moved"
        bits = fe.fused_extract_planar(got, 15.0, 1, int_path=True)
        torch.cuda.synchronize()
        want_bits = fe.fused_extract_planar_reference(got, 15.0, 1, int_path=True)
        err[EXTRACT_INT] = max(err[EXTRACT_INT], float((bits - want_bits).abs().max()))
        assert torch.equal(bits, want_bits), f"int extract {label} {fb}x{fh}x{fw}"
        f32 = fe.fused_mark_planar(planes, wm2d, 15.0, 1)
        print(f"int_path kernels: {label} {fb}x{fh}x{fw}: mark and extract equal to their plain "
              f"versions; {_frac_equal(got, f32):.6f} of the bytes equal to the float32 body's")
    return err


def run_int_path(device, cfg, source: Path) -> tuple[dict, dict]:
    """The flagship codec with ``DwtDctSvd(int_path=True)``: its two integer
    bodies held against their plain versions (``check_int_kernels``), then
    ``FrameMarker`` -> ``FrameExtractor`` on the 48 smooth 1080p frames of
    the dtcwtKey path's source: the payload in 48/48 frames, PSNR > 40 dB,
    >= 0.98 of the marked bytes equal to the float32 codec's on the same
    frames (the JAX int-path test's bar), and exactly one integer mark and
    one integer extract a batch, no float32 body.  Returns (the launch
    counts of the path, {name: max abs error})."""
    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.pipeline import FrameExtractor, FrameMarker
    from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd

    t_phase = time.perf_counter()
    errs = check_int_kernels(device, cfg, np.random.RandomState(23))
    frames = _read_rawv(source)
    n, h, w, _ = frames.shape
    batches = -(-n // cfg["b"])
    codec, f32_codec = DwtDctSvd(int_path=True), DwtDctSvd()  # the default backend: kernels
    wm = spread_wm(codec, h, w, "cpu").numpy()
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    b = cfg["b"]
    fresh_counts()
    with NoPlainOnDevice():  # a batch a call, as the CLI drives them
        fm = FrameMarker(codec, wm, b, device=device)
        marked = np.concatenate([fm.mark(frames[i:i + b]) for i in range(0, n, b)])
        fx = FrameExtractor(codec, deg, b, device=device)
        payloads = np.concatenate([fx.extract(marked[i:i + b]) for i in range(0, n, b)])
    counts = kernels.launch_counts()
    want = {kernels.MARK_INT: batches, kernels.EXTRACT_INT: batches}
    assert_counts(counts, want, "int_path")
    good = int((payloads == np.array([int(c) for c in PAYLOAD], np.uint8)).all(axis=1).sum())
    assert good == n, f"payload in {good}/{n} frames"
    mse = float(np.mean((marked.astype(np.float64) - frames) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 40.0, psnr
    fm = FrameMarker(f32_codec, wm, b, device=device)
    f32_marked = np.concatenate([fm.mark(frames[i:i + b]) for i in range(0, n, b)])
    same = float((marked == f32_marked).mean())
    assert same >= 0.98, same
    print(f"int_path {w}x{h}: {n} smooth frames through FrameMarker -> FrameExtractor with "
          f"DwtDctSvd(int_path=True): payload {PAYLOAD} in {good}/{n}, PSNR {psnr:.2f} dB, "
          f"{same:.6f} of the bytes equal to the float32 codec's; launches "
          f"{ {k: counts[k] for k in want} }; the phase {time.perf_counter() - t_phase:.1f} s")
    return want, errs


def _median_ms(fn, reps: int = 5) -> float:
    """Host-clock ms of ``fn()`` ending in a synchronise, median of ``reps``
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _same_hls_outputs(a: Path, b: Path) -> int:
    """Whether two ``hls-mark`` output dirs hold the same manifests and the
    same marked variants, byte for byte; returns the number of variants."""
    for f in ("segment_payloads.json", "segment_copies.json"):
        assert (a / f).read_text() == (b / f).read_text(), f
    names = sorted(f.name for f in (a / "marked_segments").glob("*.rawv"))
    assert names == sorted(f.name for f in (b / "marked_segments").glob("*.rawv")), names
    for name in names:
        with open(a / "marked_segments" / name, "rb") as fa, \
                open(b / "marked_segments" / name, "rb") as fb:
            while True:
                ca, cb = fa.read(1 << 26), fb.read(1 << 26)
                assert ca == cb, f"{name} differs"
                if not ca:
                    break
    return len(names)


def run_sharded_steps(device, cfg, rng, card: str) -> dict:
    """``parallel/sharded.py`` on a world-1 NCCL mesh over the card: the mark
    step with 3 variants for each codec against three bare ``mark_frames``,
    the detect step (votes through a real NCCL ``all_reduce``) and the
    spatial step at W = 1920, each path's launches counted just around it.
    Prints the steps' host-clock ms beside the bare codec calls'."""
    import torch.distributed as dist

    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.fingerprint import payload_for_segment
    from vfp_tpu_torch.parallel import make_mesh, sharded_detect_step, sharded_mark_step
    from vfp_tpu_torch.parallel import sharded as sh
    from vfp_tpu_torch.wm import (CorrShuffler, DctQim, DeShuffler, DtcwtKey, DwtDctSvd,
                                  Shuffler, block_grid)

    h, w, b = cfg["h"], cfg["w"], cfg["b"]
    frames = natural_frames(rng, b, h, w)
    mesh = make_mesh(1, 1, device=device)
    assert dist.get_backend() == "nccl" and mesh.device_type == "cuda", dist.get_backend()
    counts = collections.Counter()
    lines = []
    try:
        x = sh.shard_batch(mesh, frames)
        codecs = {"dwtDctSvd": DwtDctSvd(), "dct": DctQim(), "dtcwtKey": DtcwtKey()}
        want_counts = {"dwtDctSvd": {"fused_mark_planar": 3},
                       "dct": {"fused_dct_qim_mark": 3, "y_dc_mean": 3},
                       "dtcwtKey": {**{k: 3 for k in DTCWT}}}  # a spectrum per plane
        marked = {}
        for name, codec in codecs.items():
            cap = codec.wm_capacity((h, w, 3))
            if name == "dtcwtKey":
                planes = [CorrShuffler(key=k).generate_wm(None, cap) for k in range(3)]
            else:
                planes = [Shuffler(key=0).generate_wm(payload_for_segment(2, c), cap)
                          for c in range(3)]
            wms = np.stack([np.asarray(p, np.float32).reshape(-1) for p in planes])
            step = sharded_mark_step(mesh, codec)
            fresh_counts()
            with NoPlainOnDevice():
                out = sh.gather_marked(mesh, step(x, sh.shard_variants(mesh, wms)))
                torch.cuda.synchronize()
            assert_counts(kernels.launch_counts(), want_counts[name], f"sharded mark {name}")
            counts.update(want_counts[name])
            wdev = torch.as_tensor(wms, device=device)
            with torch.inference_mode():
                for v in range(3):
                    assert torch.equal(out[v], codec.mark_frames(x, wdev[v])), (name, v)
            assert out.shape == (3, b, h, w, 3) and out.dtype == torch.uint8
            marked[name] = (out, wms)
            wl = sh.shard_variants(mesh, wms)

            def bare():
                with torch.inference_mode():
                    return [codec.mark_frames(x, wdev[v]) for v in range(3)]

            ms = {"bare": _median_ms(bare), "step": _median_ms(lambda: step(x, wl)),
                  "whole": _median_ms(lambda: sh.gather_marked(
                      mesh, step(sh.shard_batch(mesh, frames), sh.shard_variants(mesh, wms))))}
            lines.append(f"mark {name} x3 variants {ms['step']:.3f} ms (bare mark_frames x3 "
                         f"{ms['bare']:.3f}; with shard_batch from the host and gather_marked "
                         f"{ms['whole']:.3f})")

        codec = codecs["dwtDctSvd"]
        out, _ = marked["dwtDctSvd"]
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        cands = np.stack([payload_for_segment(2, c) for c in range(3)]).astype(np.float32)
        step = sharded_detect_step(mesh, codec, deg, 3)
        fresh_counts()
        with NoPlainOnDevice():
            votes = step(out[1], cands)
            torch.cuda.synchronize()
        assert_counts(kernels.launch_counts(), {"fused_extract_planar": 1}, "sharded detect")
        counts.update(fused_extract_planar=1)
        assert votes.tolist() == [0, b, 0] and votes.is_cuda, votes

        def bare_detect():
            with torch.inference_mode():
                return deg.degenerate_batch(codec.extract_frames(out[1]))

        lines.append(f"detect C=3 {_median_ms(lambda: step(out[1], cands)):.3f} ms with its "
                     f"all_reduce (bare extract_frames + degenerate_batch "
                     f"{_median_ms(bare_detect):.3f}); votes {votes.tolist()}")

        (nbh, nbw), _ = block_grid((h, w))
        wm = marked["dwtDctSvd"][1][1]
        wm2d = wm[: nbh * nbw].reshape(nbh, nbw)
        step = sh.sharded_mark_spatial(mesh, codec, w)
        fresh_counts()
        with NoPlainOnDevice():
            got = sh.gather_axis(mesh, step(sh.shard_axis(mesh, frames, 2),
                                            sh.shard_axis(mesh, wm2d, 1)), 2)
            torch.cuda.synchronize()
        assert_counts(kernels.launch_counts(), {"fused_mark_planar": 1}, "sharded spatial")
        counts.update(fused_mark_planar=1)
        assert torch.equal(got, out[1]), "the spatial step differs from the unsharded mark"
    finally:
        dist.destroy_process_group()
    print(f"parallel: world-1 {dist.Backend.NCCL} mesh (data=1, variant=1) on "
          f"{torch.cuda.get_device_name(0)}, {b} frames of {w}x{h}; host clock, median of 5 "
          f"(card {card}): " + "; ".join(lines))
    return counts


def run_parallel_path(device, cfg, workdir: Path, hls_stats: dict) -> dict:
    """``parallel/``: the sharded steps (``run_sharded_steps``), then the HLS
    farm on the hls phase's source: ``hls-mark --copies 3 --workers 2`` (two
    spawned worker processes on the card) and ``hls-mark --distributed
    --num-processes 2 --coordinator 127.0.0.1:<port>`` (two processes of
    the CLI on the card, rank 0 merging), each writing the hls phase's
    manifests and marked bytes; the farm's launches summed from what its
    workers return (36 marks) with the parent's verify (34 extracts), the
    ranks' marks from their stats lines (36; rank 0's verify is not
    counted); then
    ``cli test-frame`` on a 1080p PNG written by the port's encoder.
    Prints the times beside the hls phase's serial ``mark_segments`` wall.
    Returns the launch counts of the phase."""
    import ast
    import shutil

    from vfp_tpu_torch import kernels
    from vfp_tpu_torch.cli import main as cli
    from vfp_tpu_torch.io import write_png
    from vfp_tpu_torch.parallel.mesh import free_port

    card = nvidia_smi_line()
    split = {}
    t_phase = time.perf_counter()
    rng = np.random.RandomState(15)
    counts = run_sharded_steps(device, cfg, rng, card)
    split["sharded steps"] = time.perf_counter() - t_phase

    root = workdir / "parallel"
    root.mkdir()
    src = workdir / "hls" / "source.rawv"
    serial = workdir / "hls" / "out"
    split["comparing"] = 0.0
    flags = ["--copies", str(HLS["copies"]), "--batch-size", str(cfg["b"]), "--device",
             str(device)]
    n_variants = HLS["copies"] * HLS["n"]
    verify_extracts = -(-n_variants // cfg["b"])

    fresh_counts()
    t0 = time.perf_counter()
    with NoPlainOnDevice():
        text = _cli_lines(cli, ["hls-mark", str(src), str(root / "farm"), *flags,
                                "--workers", "2"])
    farm_wall = time.perf_counter() - t0
    split["--workers 2"] = farm_wall
    assert "All segments were watermarked successfully!" in text, text
    stats = ast.literal_eval(text.split("mark_segments stats: ", 1)[1].splitlines()[0])
    marks = HLS["n"] // HLS["seg_frames"] * -(-HLS["seg_frames"] // cfg["b"]) * HLS["copies"]
    assert stats["launches"] == {"fused_mark_planar": marks}, stats["launches"]
    assert_counts(kernels.launch_counts(), {"fused_extract_planar": verify_extracts}, "farm")
    counts.update(fused_mark_planar=marks, fused_extract_planar=verify_extracts)
    t0 = time.perf_counter()
    n_files = _same_hls_outputs(root / "farm", serial)
    assert n_files == HLS["copies"] * HLS["n"] // HLS["seg_frames"], n_files
    shutil.rmtree(root / "farm")
    split["comparing"] += time.perf_counter() - t0

    port = free_port()
    argv = [sys.executable, "-m", "vfp_tpu_torch.cli", "hls-mark", str(src), str(root / "dist"),
            *flags, "--distributed", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*argv, "--process-id", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dist_wall = time.perf_counter() - t0
    split["--distributed"] = dist_wall
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}: {e[-3000:]}"
    assert "All segments were watermarked successfully!" in outs[0][0], outs[0][0]
    assert "rank 1: shard done" in outs[1][0], outs[1][0]
    rank_stats = [ast.literal_eval(o.split("mark_segments stats: ", 1)[1].splitlines()[0])
                  for o, _ in outs]
    assert [(s["rank"], s["world"]) for s in rank_stats] == [(0, 2), (1, 2)], rank_stats
    rank_marks = [s["launches"].get("fused_mark_planar", 0) for s in rank_stats]
    assert sum(rank_marks) == marks and all(set(s["launches"]) == {"fused_mark_planar"}
                                            for s in rank_stats), rank_stats
    counts.update(fused_mark_planar=marks)
    t0 = time.perf_counter()
    assert _same_hls_outputs(root / "dist", serial) == n_files
    shutil.rmtree(root / "dist")
    split["comparing"] += time.perf_counter() - t0

    h, w = cfg["h"], cfg["w"]
    t0 = time.perf_counter()
    png = root / "picture.png"
    write_png(png, smooth_frames(rng, 1, h, w)[0])
    fresh_counts()
    with NoPlainOnDevice():
        text = _cli_lines(cli, ["test-frame", str(png), str(root / "tf"), "--device", str(device)])
    assert f"recovered payload: {PAYLOAD} (expected {PAYLOAD})" in text, text
    assert_counts(kernels.launch_counts(), {"fused_mark_planar": 1, "fused_extract_planar": 1},
                  "test-frame")
    counts.update(fused_mark_planar=1, fused_extract_planar=1)
    psnr = text.split("PSNR ", 1)[1].split(")")[0]
    split["test-frame"] = time.perf_counter() - t0

    print(f"parallel: hls-mark {HLS['n']} frames of {w}x{h}, {HLS['copies']} copies "
          f"(card {card}): serial mark_segments (hls phase) {hls_stats['wall_seconds']} s; "
          f"--workers 2: CLI {farm_wall:.3f} s, mark_segments_parallel {stats['wall_seconds']} s "
          f"(workers' mark_segments {[s['wall_seconds'] for s in stats['workers']]} s), "
          f"launches {stats['launches']} in the workers; --distributed 2 ranks: "
          f"{dist_wall:.3f} s from the first spawn to the last exit, ranks' mark_segments "
          f"{[s['wall_seconds'] for s in rank_stats]} s with {rank_marks} marks; both byte-equal to the hls phase's "
          f"variants and manifests")
    print(f"parallel: test-frame 1080p PNG: payload {PAYLOAD} recovered, PSNR {psnr}; the "
          f"phase {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in split.items())}); launches {dict(counts)}")
    shutil.rmtree(root)
    return counts


# -- phase 5: timings -------------------------------------------------------------

def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """Device-only ms per call: ``iters`` calls captured in one CUDA graph
    and replayed between two events, so no host work (Python, the
    wrapper's checks, the launch) stands between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def device_split(fn, calls: int = 10) -> dict:
    """{kernel: device ms per call} of the launches one call of ``fn`` makes
    (a wrapper's memset, its passes), from torch.profiler's CUDA activity
    over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.device_time_total:
            ours = "vfp::" in e.key  # keep our template arguments, cut PyTorch's
            name = e.key.replace("void ", "").replace("vfp::(anonymous namespace)::", "")
            name = name.split("(")[0] if ours else name.split("<")[0].split("(")[0]
            split[name.replace("at::native::", "")] = e.device_time_total / calls / 1e3
    return split


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    mem, ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def time_kernels(device, cfg) -> dict:
    """{name: ``timing_entry``} at the main paths' shapes."""
    from vfp_tpu_torch.kernels import fused_dct_qim as dq
    from vfp_tpu_torch.kernels import fused_embed as fe
    from vfp_tpu_torch.kernels import qim
    from vfp_tpu_torch.wm import DwtDctSvd, block_grid

    rng = np.random.RandomState(3)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    codec = DwtDctSvd()
    frames = torch.as_tensor(natural_frames(rng, b, h, w), device=device)
    planes = frames.permute(0, 3, 1, 2)
    (nbh, nbw), _ = block_grid((h, w))
    wm2d = spread_wm(codec, h, w, device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
    # qim_embed_soa at the blocks the main path gives it: W % 4 != 0 frames
    m = path_soa(codec, torch.as_tensor(natural_frames(rng, b, h, cfg["narrow_w"]), device=device))
    # the triplet and the decode at the LL transport's 1080p blocks [16, 16, 32400]
    m_ll = lowlink_soa(natural_frames(rng, b, h, w), device)
    wm = torch.as_tensor(np.random.RandomState(4).randint(0, 2, m.shape[2]).astype(np.float32),
                         device=device)
    wm_dct = torch.as_tensor(np.random.RandomState(6).randint(0, 2, (h // 8, w // 8)).astype(
        np.float32), device=device)
    means = dq.y_dc_mean(planes)
    dt_cases, dt_library, dt_work, dt_shapes = dtcwt_timing_cases(device, cfg, rng)
    full_cases, full_library, full_work, full_shapes = full_dtcwt_timing_cases(device, cfg, rng)
    dt_cases.update(full_cases)
    dt_library.update(full_library)
    dt_work.update(full_work)
    dt_shapes.update(full_shapes)
    cases = {
        "fused_mark_planar": (lambda: fe.fused_mark_planar(planes, wm2d, 15.0, 1),
                              lambda: fe.fused_mark_planar_reference(planes, wm2d, 15.0, 1)),
        "fused_extract_planar": (lambda: fe.fused_extract_planar(planes, 15.0, 1),
                                 lambda: fe.fused_extract_planar_reference(planes, 15.0, 1)),
        "fused_mark_planar.int": (
            lambda: fe.fused_mark_planar(planes, wm2d, 15.0, 1, int_path=True),
            lambda: fe.fused_mark_planar_reference(planes, wm2d, 15.0, 1, int_path=True)),
        "fused_extract_planar.int": (
            lambda: fe.fused_extract_planar(planes, 15.0, 1, int_path=True),
            lambda: fe.fused_extract_planar_reference(planes, 15.0, 1, int_path=True)),
        "qim_triplet_soa": (lambda: qim.qim_triplet_soa(m_ll),
                            lambda: qim.qim_triplet_soa_reference(m_ll)),
        "qim_decode_soa": (lambda: qim.qim_decode_soa(m_ll, 15.0),
                           lambda: qim.qim_decode_soa_reference(m_ll, 15.0)),
        "qim_embed_soa": (lambda: qim.qim_embed_soa(m, wm, 15.0),
                          lambda: qim.qim_embed_soa_reference(m, wm, 15.0)),
        "fused_dct_qim_mark": (lambda: dq.fused_dct_qim_mark(planes, wm_dct, ALPHA, means),
                               lambda: dq.fused_dct_qim_mark_reference(planes, wm_dct, ALPHA,
                                                                       means)),
        "fused_dct_qim_extract": (lambda: dq.fused_dct_qim_extract(planes, ALPHA),
                                  lambda: dq.fused_dct_qim_extract_reference(planes, ALPHA)),
        "y_dc_mean": (lambda: dq.y_dc_mean(planes), lambda: dq.y_dc_mean_reference(planes)),
        **dt_cases,
    }
    # one PyTorch call that computes the same function, where there is one: the
    # dominant triplet is the first singular triplet of each 4x4 block
    # (the decode's: its singular values, whose first is s0)
    blocks4 = m_ll.permute(0, 2, 1).reshape(-1, 4, 4)
    library = {"qim_triplet_soa": lambda: torch.linalg.svd(blocks4),
               "qim_decode_soa": lambda: torch.linalg.svdvals(blocks4), **dt_library}
    frame_bytes, soa_bytes = planes.numel(), 4 * m.numel()
    nb, ns, tiles = (h // 8) * (w // 8), m.shape[0] * m.shape[2], b * (h // 8) * (w // 8)
    ll_bytes, ns_ll = 4 * m_ll.numel(), m_ll.shape[0] * m_ll.shape[2]
    work = {  # (bytes each input read once and each output written once, FLOPs)
        "fused_mark_planar": (2 * frame_bytes + 4 * wm2d.numel(), tiles),
        "fused_extract_planar": (frame_bytes + 4 * tiles, tiles),
        "fused_mark_planar.int": (2 * frame_bytes + 4 * wm2d.numel(), tiles),
        "fused_extract_planar.int": (frame_bytes + 4 * tiles, tiles),
        "qim_triplet_soa": (ll_bytes + 4 * 9 * ns_ll, ns_ll),
        "qim_decode_soa": (ll_bytes + 4 * ns_ll, ns_ll),
        "qim_embed_soa": (2 * soa_bytes + 4 * m.shape[2], ns),
        "fused_dct_qim_mark": (2 * frame_bytes + 4 * nb + 4 * b, tiles),
        "fused_dct_qim_extract": (frame_bytes + 4 * tiles + 4 * b, tiles),
        "y_dc_mean": (frame_bytes + 4 * b, b * h * w),
        **dt_work,
    }
    shapes = {name: (m.shape if name == "qim_embed_soa" else planes.shape) for name in cases}
    shapes.update({name: m_ll.shape for name in ("qim_triplet_soa", "qim_decode_soa")})
    shapes.update(dt_shapes)
    times = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    for name, (kernel, plain) in cases.items():
        # plain, kernel, kernel, plain: the median of each pair of turns
        timer = ((lambda fn, iters: _flushed_ms(fn, iters, flush)) if name in L2_FLUSHED
                 else _time_ms)
        p1 = timer(plain, max(2, cfg["iters"] // 4))
        k1 = timer(kernel, cfg["iters"])
        k2 = timer(kernel, cfg["iters"])
        p2 = timer(plain, max(2, cfg["iters"] // 4))
        lib = library.get(name)
        nbytes, units = work[name]
        times[name] = timing_entry((k1 + k2) / 2, (p1 + p2) / 2, lib, kernel, nbytes,
                                   units * FLOPS_PER_UNIT[name], cfg["iters"],
                                   capturable=name not in HOST_SYNCED_LIBRARY, timer=timer)
        if name in FLAGSHIP_BODIES:  # both bodies of the flagship kernels, also with a cold L2
            times[name]["cold_device_ms"] = (_cold_graph_ms(kernel, cfg["iters"], flush)
                                             + _cold_graph_ms(kernel, cfg["iters"], flush)) / 2
        print(timing_line(name, shapes[name], times[name], b)
              + (" [L2 flushed before each timed launch]" if name in L2_FLUSHED else "")
              + (f" [device only with a cold, clean L2 {times[name]['cold_device_ms']:.4f} ms, "
                 f"{times[name]['bound_ms'] / times[name]['cold_device_ms']:.1%} of the bound]"
                 if name in FLAGSHIP_BODIES else ""))
    del flush
    return times


# the flagship kernels' float32 and integer bodies, timed cold too
FLAGSHIP_BODIES = ("fused_mark_planar", "fused_extract_planar", "fused_mark_planar.int",
                   "fused_extract_planar.int")


# library yardsticks that wait on the host (the solver checks its status),
# so no CUDA graph can capture them: their device-only time is not measured
HOST_SYNCED_LIBRARY = {"qim_triplet_soa", "qim_decode_soa"}
# kernels whose 33 MB input would stay in the 50 MB L2 across back-to-back
# launches, where their callers hand them blocks just uploaded (the LL
# transport) or just written by ``image_to_soa`` (the 1918-wide path's
# embed, whose input and output together pass the L2's size): timed one
# launch at a time after a write of L2_FLUSH_BYTES
L2_FLUSHED = ("qim_triplet_soa", "qim_decode_soa", "qim_embed_soa")
L2_FLUSH_BYTES = 256 << 20
L2_COLD_READ_BYTES = 128 << 20  # 2.5x the L2: the graph-differenced cold time's eviction


def _flushed_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Device ms of one ``fn()`` with a cold L2: each timed launch follows a
    write of ``flush`` (5x the H100's 50 MB L2), events around the launch
    alone.  The time holds what a lone launch costs between two events
    (a few us, against back-to-back launches in a graph) and the write-back
    of the dirty lines the write left in the L2, which the launch's reads
    evict; ``_cold_graph_ms`` has neither."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _cold_graph_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Device-only ms of one ``fn()`` with a cold, clean L2: ``iters`` pairs
    of a read of ``flush`` (clean lines in the L2, none of ``fn``'s) and
    ``fn()`` in one CUDA graph, less a graph of the reads alone, over
    ``iters``."""
    evict = flush[: L2_COLD_READ_BYTES]
    return (_graph_ms(lambda: (evict.max(), fn()), iters)
            - _graph_ms(lambda: evict.max(), iters))


def path_soa(codec, frames: torch.Tensor) -> torch.Tensor:
    """The SoA blocks the flagship codec gives the QIM kernels on its
    W % 4 != 0 path: the LL band of u8 ``frames`` on the card, cut to the
    block grid."""
    from vfp_tpu_torch.ops.soa import image_to_soa
    from vfp_tpu_torch.wm import block_grid

    (nbh, nbw), _ = block_grid(tuple(frames.shape[1:3]))
    ll = codec._ll_from_frames(frames.to(torch.float32), 1)
    return image_to_soa(ll[:, : 4 * nbh, : 4 * nbw], 4)


def lowlink_soa(frames: np.ndarray, device) -> torch.Tensor:
    """The SoA blocks the LL transport gives the QIM kernels: the u8 wire's LL
    of ``frames``, uploaded and decoded on ``device``, cut to the block grid."""
    from vfp_tpu_torch.ops.soa import image_to_soa
    from vfp_tpu_torch.pipeline import lowlink

    ll = lowlink._wire_decode(torch.as_tensor(
        lowlink.wire_encode(lowlink.host_ll(frames, 1), "u8", 1), device=device), 1)
    return image_to_soa(ll[:, : ll.shape[1] // 4 * 4, : ll.shape[2] // 4 * 4], 4)


def timing_entry(ms, plain_ms, library, kernel, nbytes, flops, iters, capturable=True,
                 timer=_time_ms) -> dict:
    """One kernel's numbers: host-inclusive ms (events around back-to-back
    wrapper calls; ``timer``'s, for the L2-flushed ones), device-only ms (a
    CUDA graph, L2 warm), the library yardstick's two times, and the bound."""
    bound_ms, bound_by = bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": _graph_ms(kernel, iters),
            "library_ms": None if library is None else timer(library, 2),
            "library_device_ms": (_graph_ms(library, iters)
                                  if library is not None and capturable else None),
            "bound_ms": bound_ms, "bound_by": bound_by, "mb": nbytes / 1e6, "gflop": flops / 1e9}


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def timing_line(name, shape, t, b) -> str:
    plain = "" if t["plain_ms"] is None else (
        f", plain {t['plain_ms']:.4f} ms/batch ({b / t['plain_ms'] * 1e3:.1f} frames/s)")
    return (f"timing {name} @ {tuple(shape)}: kernel {t['ms']:.4f} ms/batch "
            f"({b / t['ms'] * 1e3:.1f} frames/s; device only {t['device_ms']:.4f} ms){plain}, "
            f"library {_ms(t['library_ms'])} (device only {_ms(t['library_device_ms'])}), "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['mb']:.1f} MB, "
            f"{t['gflop']:.3f} GFLOP), kernel at {t['bound_ms'] / t['ms']:.1%} of the bound "
            f"({t['bound_ms'] / t['device_ms']:.1%} device only)")


def _tree_weights(filters_r, filters_c) -> torch.Tensor:
    """[n, 1, 6, 6] conv2d weights of the level-1 tree filters over a 6x6 patch
    (row 2m - 4 + a, column 2n - 4 + b): w[a][b] = fr[rt - kr + 4] * fc[ct - kc + 4],
    in the kernels' plane order (band, then combo (rt, ct))."""
    ws = []
    for fr, fc in zip(filters_r, filters_c):
        for rt in range(2):
            for ct in range(2):
                wt = np.zeros((6, 6), np.float32)
                for kr, a in enumerate(fr):
                    for kc, c in enumerate(fc):
                        wt[rt - kr + 4, ct - kc + 4] = np.float32(a) * np.float32(c)
                ws.append(wt)
    return torch.as_tensor(np.stack(ws)[:, None])


def _qshift_weights(trees_bands) -> torch.Tensor:
    """[n, 1, 14, 14] conv2d weights of q-shift tree filters over a window
    padded 13 rows and columns before: w[13 - kr][13 - kc] = fr[kr] * fc[kc]."""
    ws = []
    for fr, fc in trees_bands:
        wt = np.zeros((14, 14), np.float32)
        for kr, a in enumerate(fr):
            for kc, c in enumerate(fc):
                wt[13 - kr, 13 - kc] = np.float32(a) * np.float32(c)
        ws.append(wt)
    return torch.as_tensor(np.stack(ws)[:, None])


def _legall_weights(bands) -> torch.Tensor:
    """[4 x len(bands), 1, 6, 6] conv_transpose2d weights of the LeGall
    synthesis of the given bands (0 ll, 1 lh, 2 hl, 3 hh), band-major: tree
    (rt, ct)'s sampling phase shifts the taps, w[rt + kr][ct + kc] = 0.25 *
    fr[kr] * fc[kc], with rows g0 (ll, lh) or g1 (hl, hh) and columns g0 (ll,
    hl) or g1 (lh, hh)."""
    from vfp_tpu_torch.ops import dtcwt_coeffs as C

    ws = []
    for band in bands:
        fr = (C.LEGALL_G0, C.LEGALL_G1)[band >> 1]
        fc = (C.LEGALL_G0, C.LEGALL_G1)[band & 1]
        for rt in range(2):
            for ct in range(2):
                wt = np.zeros((6, 6), np.float32)
                for kr, a in enumerate(fr):
                    for kc, c in enumerate(fc):
                        wt[rt + kr, ct + kc] = np.float32(0.25) * np.float32(a) * np.float32(c)
                ws.append(wt)
    return torch.as_tensor(np.stack(ws)[:, None])


def _qshift_synthesis_weights(nbands: int) -> torch.Tensor:
    """[4 x nbands, 1, 14, 14] grouped conv_transpose2d weights of the q-shift
    synthesis, tree-major (the first ``nbands`` of ll, lh, hl, hh per tree):
    w[kr][kc] = fr[kr] * fc[kc], rows g0r (ll, lh) or g1r (hl, hh), columns
    g0c (ll, hl) or g1c (lh, hh)."""
    from vfp_tpu_torch.ops.dtcwt import _qshift

    ws = []
    for rt in range(2):
        for ct in range(2):
            for band in range(nbands):
                fr = _qshift(rt)[2 + (band >> 1)]
                fc = _qshift(ct)[2 + (band & 1)]
                ws.append(np.outer(np.asarray(fr, np.float32), np.asarray(fc, np.float32)))
    return torch.as_tensor(np.stack(ws)[:, None])


def dtcwt_timing_cases(device, cfg, rng):
    """The DT-CWT kernels at the main path's shapes (16 frames of 1080p; the
    136x240 watermark plane): (cases, library calls, (bytes, units), shapes).
    The library yardsticks, each one call over an input padded circularly
    beforehand: for the level-1 kernels a stride-2 F.conv2d with the tree
    filters as a [n, 1, 6, 6] weight (for ll_y and ll_color: over the Y (and
    U) plane, the lincomb not included); for the q-shift levels a grouped
    stride-2 F.conv2d with each tree's separable filters as [4 or 12, 1, 14,
    14] weights (its highpass planes come out tree-major, a permutation of
    the kernel's band-major order); for the synthesis a stride-2
    F.conv_transpose2d of the 12 planes into one, the phases and 0.25 in
    the weights and the roll in the crop (a view)."""
    from vfp_tpu_torch.kernels import dtcwt_delta as dd, dtcwt_level1 as dl, dtcwt_masks as dm
    from vfp_tpu_torch.kernels import dtcwt_synthesis as ds
    from vfp_tpu_torch.kernels.fused_dct_qim import _lincomb
    from vfp_tpu_torch.ops import dtcwt_coeffs as C
    from vfp_tpu_torch.ops.dtcwt import _qshift
    from vfp_tpu_torch.wm import DtcwtKey

    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    codec = DtcwtKey()
    frames = torch.as_tensor(smooth_frames(rng, b, h, w), device=device)
    ll = dl.dtcwt_level1_ll_y(frames)
    masks = dm.dtcwt_qshift_masks(ll, codec.step)
    wm = key_wm(codec, h, w, device).reshape(1, *codec.wm_capacity((h, w, 3)))
    dsubs = codec._delta_subs(masks, codec.wm_highpass(wm[0])).contiguous()
    # the detect path's inputs: the marked batch's level-1 output, its U half
    # in place, level 2, and the codec's own folded level-3 planes
    marked = codec.mark_frames(frames, key_wm(codec, h, w, device))
    llc = dl.dtcwt_level1_ll_color(marked)
    u_ll1 = llc[:, 1]
    u_ll2 = dl.dtcwt_qshift_ll(u_ll1)
    u_hp3 = dl.dtcwt_qshift_hp(u_ll2)
    folded = codec._decode_coeffs(u_hp3, dm.dtcwt_qshift_masks(llc[:, 0], codec.step),
                                  lambda subs: subs)
    cases = {
        "dtcwt_level1_ll_y": (lambda: dl.dtcwt_level1_ll_y(frames),
                              lambda: dl.dtcwt_level1_ll_y_reference(frames)),
        "dtcwt_qshift_masks": (lambda: dm.dtcwt_qshift_masks(ll, codec.step),
                               lambda: dm.dtcwt_qshift_masks_reference(ll, codec.step)),
        "dtcwt_delta_synthesis": (lambda: dd.dtcwt_delta_synthesis(dsubs),
                                  lambda: dd.dtcwt_delta_synthesis_reference(dsubs)),
        "dtcwt_level1_analysis": (lambda: dl.dtcwt_level1_analysis(wm),
                                  lambda: dl.dtcwt_level1_analysis_reference(wm)),
        "dtcwt_level1_ll_color": (lambda: dl.dtcwt_level1_ll_color(marked),
                                  lambda: dl.dtcwt_level1_ll_color_reference(marked)),
        "dtcwt_qshift_ll": (lambda: dl.dtcwt_qshift_ll(u_ll1),
                            lambda: dl.dtcwt_qshift_ll_reference(u_ll1)),
        "dtcwt_qshift_hp": (lambda: dl.dtcwt_qshift_hp(u_ll2),
                            lambda: dl.dtcwt_qshift_hp_reference(u_ll2)),
        "dtcwt_legall_synthesis_hp": (lambda: ds.dtcwt_legall_synthesis_hp(folded),
                                      lambda: ds.dtcwt_legall_synthesis_hp_reference(folded)),
    }
    pad = (4, 1, 4, 1)
    y = _lincomb(frames.permute(0, 3, 1, 2), 0)
    ypad = torch.nn.functional.pad(y[:, None], pad, mode="circular")
    wpad = torch.nn.functional.pad(wm[:, None], pad, mode="circular")
    w4 = _tree_weights([C.LEGALL_H0], [C.LEGALL_H0]).to(device)
    w16 = _tree_weights([C.LEGALL_H0, C.LEGALL_H0, C.LEGALL_H1, C.LEGALL_H1],
                        [C.LEGALL_H0, C.LEGALL_H1, C.LEGALL_H0, C.LEGALL_H1]).to(device)
    conv = torch.nn.functional.conv2d
    mp = marked.permute(0, 3, 1, 2)
    yupad = torch.nn.functional.pad(torch.cat([_lincomb(mp, 0), _lincomb(mp, 1)])[:, None], pad,
                                    mode="circular")
    wq4 = _qshift_weights([(_qshift(rt)[0], _qshift(ct)[0])
                           for rt in range(2) for ct in range(2)]).to(device)
    wq12 = _qshift_weights([(fr, fc) for rt in range(2) for ct in range(2)
                            for fr, fc in ((_qshift(rt)[0], _qshift(ct)[1]),
                                           (_qshift(rt)[1], _qshift(ct)[0]),
                                           (_qshift(rt)[1], _qshift(ct)[1]))
                            ]).to(device)
    u1pad = torch.nn.functional.pad(u_ll1, (13, 0, 13, 0), mode="circular")
    u2pad = torch.nn.functional.pad(u_ll2, (13, 0, 13, 0), mode="circular")
    fpad = torch.nn.functional.pad(folded, (1, 2, 1, 2), mode="circular")
    wsyn = _legall_weights((1, 2, 3)).to(device)
    hh, ww = folded.shape[-2:]
    library = {
        "dtcwt_level1_ll_y": lambda: conv(ypad, w4, stride=2),
        "dtcwt_level1_analysis": lambda: conv(wpad, w16, stride=2),
        "dtcwt_level1_ll_color": lambda: conv(yupad, w4, stride=2),
        "dtcwt_qshift_ll": lambda: conv(u1pad, wq4, stride=2, groups=4),
        "dtcwt_qshift_hp": lambda: conv(u2pad, wq12, stride=2, groups=4),
        "dtcwt_legall_synthesis_hp": lambda: torch.nn.functional.conv_transpose2d(
            fpad, wsyn, stride=2)[:, 0, 5:5 + 2 * hh, 5:5 + 2 * ww],
    }
    band_major = torch.arange(12).reshape(4, 3).t().reshape(-1)  # tree-major -> the kernel's order
    diffs = {
        "level-1 analysis of the watermark plane": (
            library["dtcwt_level1_analysis"](), dl.dtcwt_level1_analysis(wm)),
        "Y/U level 1": (library["dtcwt_level1_ll_color"]().reshape(2, b, 4, h // 2, w // 2)
                        .transpose(0, 1), llc),
        "U level 2": (library["dtcwt_qshift_ll"](), u_ll2),
        "U level 3": (library["dtcwt_qshift_hp"]()[:, band_major], u_hp3),
        "LeGall synthesis": (library["dtcwt_legall_synthesis_hp"](),
                             ds.dtcwt_legall_synthesis_hp(folded)),
    }
    print("timing library yardsticks differ from the kernels by: " + ", ".join(
        f"{k} {float((a - b_).abs().max()):.3g} (of max {float(b_.abs().max()):.3g})"
        for k, (a, b_) in diffs.items()))
    n1, n2, n3 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4), b * (h // 8) * (w // 8)
    work = {
        "dtcwt_level1_ll_y": (frames.numel() + 4 * ll.numel(), n1),
        "dtcwt_qshift_masks": (4 * ll.numel() + 4 * masks.numel(), n3),
        "dtcwt_delta_synthesis": (4 * dsubs.numel() + 4 * b * h * w, b * h * w),
        "dtcwt_level1_analysis": (4 * wm.numel() + 4 * 16 * wm.numel() // 4, wm.numel() // 4),
        "dtcwt_level1_ll_color": (marked.numel() + 4 * llc.numel(), n1),
        "dtcwt_qshift_ll": (4 * u_ll1.numel() + 4 * u_ll2.numel(), n2),
        "dtcwt_qshift_hp": (4 * u_ll2.numel() + 4 * u_hp3.numel(), n3),
        "dtcwt_legall_synthesis_hp": (4 * folded.numel() + 4 * b * 4 * hh * ww, b * 4 * hh * ww),
    }
    shapes = {"dtcwt_level1_ll_y": frames.shape, "dtcwt_qshift_masks": ll.shape,
              "dtcwt_delta_synthesis": dsubs.shape, "dtcwt_level1_analysis": wm.shape,
              "dtcwt_level1_ll_color": marked.shape, "dtcwt_qshift_ll": u_ll1.shape,
              "dtcwt_qshift_hp": u_ll2.shape, "dtcwt_legall_synthesis_hp": folded.shape}
    return cases, library, work, shapes


def full_dtcwt_timing_cases(device, cfg, rng):
    """The six kernels of the rest of the transform at the new paths' shapes:
    level 1 lowpass-only on [Y; U] of a 1080p batch [32, 1080, 1920] (path 2's
    detect), a full q-shift level on its output [32, 4, 540, 960] (path 3's
    level 2), the full LeGall synthesis of [16, 16, 540, 960] (path 3's U
    inverse) and path 1's three synthesis stages at 1920x804.  The library
    yardsticks, one call each over an input padded circularly beforehand:
    a stride-2 F.conv2d with the LeGall tree weights [4, 1, 6, 6]; a grouped
    stride-2 F.conv2d with [16, 1, 14, 14] q-shift weights (planes come out
    tree-major); a grouped stride-2 F.conv_transpose2d with [16 or 4, 1, 14,
    14] weights for the q-shift syntheses (the input tree-major, the roll in
    the crop); a stride-2 F.conv_transpose2d of 16 or 4 planes into one for
    the LeGall syntheses (phases and 0.25 in the weights, the roll in the
    crop).  Returns (cases, library calls, (bytes, units), shapes)."""
    from vfp_tpu_torch.kernels import dtcwt_level1 as dl, dtcwt_synthesis as ds
    from vfp_tpu_torch.ops import dtcwt_coeffs as C
    from vfp_tpu_torch.ops.color import bgr_to_yuv
    from vfp_tpu_torch.ops.dtcwt import _qshift

    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    F = torch.nn.functional
    yuv = bgr_to_yuv(torch.as_tensor(smooth_frames(rng, b, h, w), device=device).to(
        torch.float32))
    x32 = torch.cat([yuv[..., 0], yuv[..., 1]]).contiguous()
    del yuv
    ll1 = dl.dtcwt_level1_analysis_ll(x32)
    planes1 = dl.dtcwt_level1_analysis(x32[:b])
    d3, dll2, dll1 = scope_delta_stages(device, cfg, rng)
    inputs = {"dtcwt_level1_analysis_ll": x32, "dtcwt_qshift_analysis": ll1,
              "dtcwt_legall_synthesis": planes1, "dtcwt_qshift_synthesis": d3,
              "dtcwt_qshift_synthesis_ll": dll2, "dtcwt_legall_synthesis_ll": dll1}
    cases = {}
    for name, x in inputs.items():
        module = dl if hasattr(dl, name) else ds
        cases[name] = (lambda f=getattr(module, name), x=x: f(x),
                       lambda f=getattr(module, name + "_reference"), x=x: f(x))
    tree_major = torch.arange(16, device=device).reshape(4, 4).t().reshape(-1)
    x32pad = F.pad(x32[:, None], (4, 1, 4, 1), mode="circular")
    w4 = _tree_weights([C.LEGALL_H0], [C.LEGALL_H0]).to(device)
    ll1pad = F.pad(ll1, (13, 0, 13, 0), mode="circular")
    wq16 = _qshift_weights([(_qshift(rt)[band >> 1], _qshift(ct)[band & 1])
                            for rt in range(2) for ct in range(2) for band in range(4)]).to(device)
    d3pad = F.pad(d3[:, tree_major], (7, 7, 7, 7), mode="circular")
    dll2pad = F.pad(dll2, (7, 7, 7, 7), mode="circular")
    wqs16, wqs4 = _qshift_synthesis_weights(4).to(device), _qshift_synthesis_weights(1).to(device)
    p1pad = F.pad(planes1, (1, 2, 1, 2), mode="circular")
    dll1pad = F.pad(dll1, (1, 2, 1, 2), mode="circular")
    wl16, wl4 = _legall_weights(range(4)).to(device), _legall_weights((0,)).to(device)

    def crop(y, x, off):  # the roll as a window of the transposed convolution's output
        return y[..., off:off + 2 * x.shape[-2], off:off + 2 * x.shape[-1]]

    library = {
        "dtcwt_level1_analysis_ll": lambda: F.conv2d(x32pad, w4, stride=2),
        "dtcwt_qshift_analysis": lambda: F.conv2d(ll1pad, wq16, stride=2, groups=4),
        "dtcwt_qshift_synthesis": lambda: crop(
            F.conv_transpose2d(d3pad, wqs16, stride=2, groups=4), d3, 27),
        "dtcwt_qshift_synthesis_ll": lambda: crop(
            F.conv_transpose2d(dll2pad, wqs4, stride=2, groups=4), dll2, 27),
        "dtcwt_legall_synthesis": lambda: crop(
            F.conv_transpose2d(p1pad, wl16, stride=2)[:, 0], planes1, 5),
        "dtcwt_legall_synthesis_ll": lambda: crop(
            F.conv_transpose2d(dll1pad, wl4, stride=2)[:, 0], dll1, 5),
    }
    outs = {name: fn() for name, (fn, _) in cases.items()}
    lib_outs = {name: fn() for name, fn in library.items()}
    lib_outs["dtcwt_qshift_analysis"] = lib_outs["dtcwt_qshift_analysis"][:, tree_major]
    print("timing library yardsticks differ from the kernels by: " + ", ".join(
        f"{k} {float((lib_outs[k] - v).abs().max()):.3g} (of max {float(v.abs().max()):.3g})"
        for k, v in outs.items()))
    work = {name: (4 * x.numel() + 4 * outs[name].numel(), outs[name].numel())
            for name, x in inputs.items()}
    # units: positions for the analyses (level-1 positions, q-shift output positions)
    work["dtcwt_level1_analysis_ll"] = (work["dtcwt_level1_analysis_ll"][0],
                                        outs["dtcwt_level1_analysis_ll"].numel() // 4)
    work["dtcwt_qshift_analysis"] = (work["dtcwt_qshift_analysis"][0],
                                     outs["dtcwt_qshift_analysis"].numel() // 16)
    shapes = {name: x.shape for name, x in inputs.items()}
    del outs, lib_outs
    return cases, library, work, shapes


def redesign_sweep(device, cfg, occupancy: bool = True, only: str | None = None
                   ) -> tuple[dict, dict]:
    """The kernels redesigned for Hopper at every shape the paths give them,
    each input made as the path makes it:

    - ``dtcwt_level1_analysis`` on the watermark plane [1, 136, 240], on
      [Y; U] of 16 720p frames [32, 720, 1280] (path 3's level 1) and on a
      1080p batch [16, 1080, 1920] (the round trip);
    - ``dtcwt_qshift_analysis`` on [32, 4, 540, 960] (level 2 of path 2's
      [Y; U], contiguous), on path 3's three levels [32, 4, 360, 640],
      [32, 4, 180, 320] and [32, 4, 90, 160] and on the round trip's
      [16, 4, 540, 960], each ``planes[:, :4]`` of the level before, a
      batch-strided view read in place;
    - ``dtcwt_legall_synthesis`` on the round trip's [16, 16, 540, 960] and
      on 16 720p frames' level-1 planes [16, 16, 360, 640] (path 3's U
      inverse); ``dtcwt_legall_synthesis_ll`` on path 1's level-1 lowpasses
      [16, 4, 402, 960]; ``dtcwt_legall_synthesis_hp`` on the 1080p detect
      path's folded planes [16, 12, 68, 120];
    - ``dtcwt_qshift_masks`` on the mark path's contiguous Y lowpasses
      [16, 4, 540, 960] and on the detect path's ``ll[:, 0]`` of the
      [16, 2, 4, 540, 960] level-1 output, read in place;
    - ``dtcwt_qshift_synthesis`` on path 1's level-3 delta planes [16, 16,
      101, 240], on the planes of path 3's U inverse, levels 4 to 2, [16, 16,
      45, 80], [16, 16, 90, 160] and [16, 16, 180, 320], and on the 1080p
      round trip's [16, 16, 68, 120], [16, 16, 135, 240] and [16, 16, 270,
      480] (the forward's own planes at each level); ``_ll`` on path 1's
      cropped level-2 lowpasses [16, 4, 201, 480];
    - ``dtcwt_delta_synthesis`` on the 1080p mark glue's delta planes [16,
      12, 135, 240];
    - ``dtcwt_level1_ll_y`` on the mark paths' smooth frames [16, 1080, 1920,
      3] and [16, 804, 1920, 3] and on [2, 480, 856, 3];
      ``dtcwt_level1_ll_color`` on the detect paths' inputs, those two
      batches marked by the codec;
    - ``fused_mark_planar`` and its integer body (``fused_mark_planar.int``)
      on the interleaved view ``frames.permute(0, 3, 1, 2)`` of [16, 1080,
      1920], [2, 480, 856] and [2, 1078, 1920] frames, with the spread
      watermark's bits, as phase 3 gives them;
    - ``dtcwt_level1_analysis_ll`` on path 2's [Y; U] [32, 1080, 1920], on
      its mark input ``bgr_to_yuv(frames)[..., 0]`` [16, 1080, 1920] read in
      place (its yardstick: the contiguous copy a wrapper that takes
      contiguous input makes first, timed apart) and on phase 3's padded
      854x480, 853x480 and 2048x858 pyramid inputs;
    - ``fused_dct_qim_mark`` on the interleaved view of [16, 1080, 1920]
      frames and on its contiguous planar copy, on [2, 480, 856] (rows 8-byte
      aligned only) and on [2, 1080, 1920] frames with flat tiles, with
      random bits and ``y_dc_mean``'s means given; ``y_dc_mean`` and
      ``fused_dct_qim_extract`` on the same four inputs (the extract as the
      codec's detect calls it: two launches, the mean taken in the frame's
      one read);
    - ``qim_decode_soa`` on the LL transport's [16, 16, 32400] blocks, the
      1918-wide path's [16, 16, 32265] and a 2 x 360 x 714 batch's [2, 16,
      4005]; ``qim_triplet_soa`` on the first two, ``qim_embed_soa`` on the
      last two with random bits (the three timed one launch at a time after
      a write that flushes the L2, as ``time_kernels`` times them, and
      device-only with a cold, clean L2, ``_cold_graph_ms``);
      ``fused_extract_planar`` and its integer body on the interleaved view
      of 1080p frames (both flagship kernels' bodies also cold).

    At each shape: the kernel against its plain version (equal), its
    host-inclusive and device-only times, the yardstick's where there is one
    (a stride-2 ``F.conv2d`` for the analyses, for the u8 lowpasses over the
    lincombed Y (and U) plane, a stride-2 ``F.conv_transpose2d`` for the
    syntheses, over the input padded circularly beforehand, as in
    ``dtcwt_timing_cases`` and ``full_dtcwt_timing_cases``; for the delta,
    which no one PyTorch call computes, the chain of the three synthesis
    kernels it fuses, ``dtcwt_qshift_synthesis`` -> ``_ll`` ->
    ``dtcwt_legall_synthesis_ll``, on the same planes with the zero
    lowpasses concatenated beforehand; for the Y mean PyTorch's int64 sum
    of the same view, ``planes.sum(dim=(2, 3), dtype=torch.int64)``, the
    same bytes reduced; none for the masks, the marks and the extract),
    the bound (the bytes at each tensor's element size, for a view read in
    place those of the rows it touches; for the marks the frame read and
    written, the f32 bits and means; for the Y mean and the extracts one
    read of the frame, the bits and means; for the QIM kernels the blocks
    read, the outputs written and the embed's bits), and with ``occupancy``
    the launch geometry beside ptxas's report.  ``only``: the kernels whose
    name has one of its comma-separated parts.  Only the wrappers' public
    functions (and the codec's, to make the path inputs) are called, so
    ``--package-root`` can point this at another checkout's package; one
    whose Y mean is a float64 sum (before the exact fixed-point sum) is held
    as it was, the mean by rtol 1e-6 and the extract's bits by >= 99.9%.
    Returns ({name: [entry per shape]}, {name: max abs error})."""
    from vfp_tpu_torch.kernels import _build, dtcwt_level1 as dl, dtcwt_masks as dm
    from vfp_tpu_torch.kernels import dtcwt_delta as dd, dtcwt_synthesis as ds
    from vfp_tpu_torch.kernels import fused_dct_qim as dq, fused_embed as fe, qim
    from vfp_tpu_torch.kernels.fused_dct_qim import _lincomb
    from vfp_tpu_torch.ops import dtcwt_coeffs as C
    from vfp_tpu_torch.ops.color import bgr_to_yuv
    from vfp_tpu_torch.ops.dtcwt import Transform2d, _pad_even, _qshift
    from vfp_tpu_torch.wm import DtcwtKey, DwtDctSvd, block_grid

    F = torch.nn.functional
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    codec = DtcwtKey()
    rng = np.random.RandomState(31)
    wm = key_wm(codec, h, w, device).reshape(1, *codec.wm_capacity((h, w, 3)))
    w16 = _tree_weights([C.LEGALL_H0, C.LEGALL_H0, C.LEGALL_H1, C.LEGALL_H1],
                        [C.LEGALL_H0, C.LEGALL_H1, C.LEGALL_H0, C.LEGALL_H1]).to(device)
    wq16 = _qshift_weights([(_qshift(rt)[band >> 1], _qshift(ct)[band & 1])
                            for rt in range(2) for ct in range(2) for band in range(4)]).to(device)
    wsyn = {"dtcwt_legall_synthesis": _legall_weights(range(4)).to(device),
            "dtcwt_legall_synthesis_ll": _legall_weights((0,)).to(device),
            "dtcwt_legall_synthesis_hp": _legall_weights((1, 2, 3)).to(device),
            "dtcwt_qshift_synthesis": _qshift_synthesis_weights(4).to(device),
            "dtcwt_qshift_synthesis_ll": _qshift_synthesis_weights(1).to(device)}
    tree_major = torch.arange(16, device=device).reshape(4, 4).t().reshape(-1)
    report = ptxas_report(_build.build_log) if occupancy else {}
    gen = torch.Generator(device=device).manual_seed(29)
    x720 = torch.rand((2 * b, cfg["depth_h"], cfg["depth_w"]), generator=gen, device=device) * 255
    x1080 = torch.rand((b, h, w), generator=gen, device=device) * 255
    l1_720 = dl.dtcwt_level1_analysis(x720)
    l2_720 = dl.dtcwt_qshift_analysis(l1_720[:, :4])
    l3_720 = dl.dtcwt_qshift_analysis(l2_720[:, :4])
    l1_1080 = dl.dtcwt_level1_analysis(x1080)
    ll_1080 = dl.dtcwt_level1_analysis_ll(torch.cat([x1080, x1080.flip(-1)]))
    # the DT-CWT key codec's 1080p inputs: the mark path's Y lowpasses, the
    # detect path's level-1 output of the marked batch and its folded planes
    frames = torch.as_tensor(smooth_frames(rng, b, h, w), device=device)
    marked = codec.mark_frames(frames, key_wm(codec, h, w, device))
    ll_y = dl.dtcwt_level1_ll_y(frames)
    llc = dl.dtcwt_level1_ll_color(marked)
    u_hp3 = dl.dtcwt_qshift_hp(dl.dtcwt_qshift_ll(llc[:, 1]))
    folded = codec._decode_coeffs(u_hp3, dm.dtcwt_qshift_masks(llc[:, 0], codec.step),
                                  lambda subs: subs)
    dsubs = codec._delta_subs(dm.dtcwt_qshift_masks(ll_y, codec.step),
                              codec.wm_highpass(wm[0])).contiguous()
    d3, dll2, dll1 = scope_delta_stages(device, cfg, rng)
    # the q-shift levels 2-4 of path 3's U inverse (the U half of [Y; U]) and
    # of the 1080p round trip, from the forward's raw planes
    t4 = Transform2d("kernel")
    u_levels = t4.forward_raw(x720[b:], 4)[0][1:]
    rt_levels = t4.forward_raw(x1080, 4)[0][1:]
    del u_hp3
    # the level-1 u8 lowpasses' other inputs: the 1920x804 mark and detect
    # batches, a 480x856 batch
    scope_h, prime = cfg["scope_h"], (cfg["prime_h"], cfg["prime_w"])
    scope = torch.as_tensor(smooth_frames(rng, b, scope_h, w), device=device)
    scope_marked = codec.mark_frames(scope, key_wm(codec, scope_h, w, device))
    f480 = torch.as_tensor(smooth_frames(rng, 2, *prime), device=device)
    # level 1 lowpass-only: path 2's detect input [Y; U] and its mark input,
    # the Y channel of the YUV batch (a view, 12 bytes a pixel apart), and
    # phase 3's padded pyramid inputs (W % 4 == 2; an odd level-1 height)
    yuv = bgr_to_yuv(torch.as_tensor(smooth_frames(rng, b, h, w), device=device).to(
        torch.float32))
    y_view = yuv[..., 0]
    x32 = torch.cat([y_view, yuv[..., 1]])
    pyramid_inputs = [_pad_even(torch.as_tensor(rng.rand(2, fh, fw).astype(np.float32) * 255,
                                                device=device))[0]
                      for fh, fw in ((prime[0], 854), (prime[0], 853), (858, 2048))]
    # the DCT-QIM mark's inputs, as phase 3 makes them: the interleaved view of
    # 1080p frames and its planar copy, a 480x856 batch (rows 8-byte aligned
    # only) and flat tiles; the means and bits given, as in time_kernels
    dct_args = []
    for fb, fh, fw, flat in ((b, h, w, False), (2, *prime, False), (2, h, w, True)):
        fr = natural_frames(rng, fb, fh, fw)
        planes = torch.as_tensor(_with_flat_blocks(fr) if flat else fr, device=device).permute(
            0, 3, 1, 2)
        bits = torch.as_tensor(rng.randint(0, 2, (fh // 8, fw // 8)).astype(np.float32),
                               device=device)
        views = (planes, planes.contiguous()) if fb == b else (planes,)
        dct_args += [(v, bits, ALPHA, dq.y_dc_mean(v)) for v in views]
    dct_cases = [c for v, _, _, _ in dct_args for c in (
        ("y_dc_mean", (v,)), ("fused_dct_qim_extract", (v, ALPHA)))]
    exact_mean = hasattr(dq, "Y_SCALE")  # else a float64 mean, held as it was
    # the flagship mark's inputs, as phase 3 makes them
    flagship = DwtDctSvd()
    mark_args = []
    for fb, fh, fw in ((b, h, w), (2, *prime), (2, cfg["tail_h"], w)):
        planes = torch.as_tensor(natural_frames(rng, fb, fh, fw), device=device).permute(0, 3, 1, 2)
        (nbh, nbw), _ = block_grid((fh, fw))
        wm2d = spread_wm(flagship, fh, fw, device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
        mark_args.append((planes, wm2d, 15.0, 1))
    # the QIM kernels' inputs, as the paths make them: the LL transport's
    # 1080p blocks [16, 16, 32400], the 1918-wide path's [16, 16, 32265] and
    # a 2 x 360 x 714 batch's [2, 16, 4005], with random bits for the embed;
    # and the flagship extract on the interleaved view of 1080p frames
    soa = [lowlink_soa(natural_frames(rng, b, h, w), device)] + [
        path_soa(flagship, torch.as_tensor(natural_frames(rng, fb, fh, fw), device=device))
        for fb, fh, fw in ((b, h, cfg["narrow_w"]), (2, 360, 714))]
    soa_bits = [torch.as_tensor(rng.randint(0, 2, m.shape[2]).astype(np.float32), device=device)
                for m in soa]
    qim_cases = [*(("qim_decode_soa", (m, 15.0)) for m in soa),
                 *(("qim_triplet_soa", (m,)) for m in soa[:2]),
                 *(("qim_embed_soa", (m, bits, 15.0)) for m, bits in zip(soa[1:], soa_bits[1:])),
                 ("fused_extract_planar", (mark_args[0][0], 15.0, 1)),
                 ("fused_extract_planar.int", (mark_args[0][0], 15.0, 1))]
    cases = [("dtcwt_level1_analysis", (wm,)), ("dtcwt_level1_analysis", (x720,)),
             ("dtcwt_level1_analysis", (x1080,)), ("dtcwt_qshift_analysis", (ll_1080,)),
             ("dtcwt_qshift_analysis", (l1_720[:, :4],)),
             ("dtcwt_qshift_analysis", (l2_720[:, :4],)),
             ("dtcwt_qshift_analysis", (l3_720[:, :4],)),
             ("dtcwt_qshift_analysis", (l1_1080[:, :4],)),
             ("dtcwt_legall_synthesis", (l1_1080,)), ("dtcwt_legall_synthesis", (l1_720[:b],)),
             ("dtcwt_legall_synthesis_ll", (dll1,)), ("dtcwt_legall_synthesis_hp", (folded,)),
             ("dtcwt_qshift_masks", (ll_y, codec.step)),
             ("dtcwt_qshift_masks", (llc[:, 0], codec.step)),
             ("dtcwt_qshift_synthesis", (d3,)),
             *(("dtcwt_qshift_synthesis", (x,)) for x in u_levels[::-1] + rt_levels[::-1]),
             ("dtcwt_qshift_synthesis_ll", (dll2,)), ("dtcwt_delta_synthesis", (dsubs,)),
             ("dtcwt_level1_ll_y", (frames,)), ("dtcwt_level1_ll_y", (scope,)),
             ("dtcwt_level1_ll_y", (f480,)), ("dtcwt_level1_ll_color", (marked,)),
             ("dtcwt_level1_ll_color", (scope_marked,)),
             *(("fused_mark_planar", args) for args in mark_args),
             *(("fused_mark_planar.int", args) for args in mark_args),
             ("dtcwt_level1_analysis_ll", (x32,)), ("dtcwt_level1_analysis_ll", (y_view,)),
             *(("dtcwt_level1_analysis_ll", (x,)) for x in pyramid_inputs),
             *(("fused_dct_qim_mark", args) for args in dct_args), *dct_cases, *qim_cases]
    if not hasattr(fe.fused_mark_planar, "int_launches"):  # a package from before the int bodies
        cases = [case for case in cases if not case[0].endswith(".int")]
    if only is not None:
        cases = [case for case in cases if any(part in case[0] for part in only.split(","))]
    w4 = _tree_weights([C.LEGALL_H0], [C.LEGALL_H0]).to(device)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    entries, errs = collections.defaultdict(list), collections.defaultdict(float)
    for name, args in cases:
        x = args[0]
        base, _, body = name.partition(".")  # "<wrapper>.int": its integer body
        module = next(m for m in (dl, ds, dd, dm, fe, dq, qim) if hasattr(m, base))
        kernel, plain = getattr(module, base), getattr(module, base + "_reference")
        if body == "int":
            kernel, plain = (functools.partial(kernel, int_path=True),
                             functools.partial(plain, int_path=True))
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        gots, wants = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(float((g.double() - r.double()).abs().max()) for g, r in zip(gots, wants))
        if exact_mean or name not in ("y_dc_mean", "fused_dct_qim_extract"):
            assert all(torch.equal(g, r) for g, r in zip(gots, wants)), \
                f"{name} {tuple(x.shape)}: max err {err}"
        elif name == "y_dc_mean":
            assert torch.allclose(got, want, rtol=1e-6, atol=0), (got, want)
        else:
            assert _frac_equal(got, want) >= 0.999, f"{name} {tuple(x.shape)}"
        errs[name] = max(errs[name], err)
        if name == "dtcwt_level1_analysis":
            xpad = F.pad(x[:, None], (4, 1, 4, 1), mode="circular")
            library = lambda xpad=xpad: F.conv2d(xpad, w16, stride=2)  # noqa: E731
        elif name == "dtcwt_level1_analysis_ll" and not x.is_contiguous():
            # the Y view: the copy a wrapper that takes contiguous input makes first
            xpad, library = None, lambda x=x: x.contiguous()  # noqa: E731
        elif name == "dtcwt_level1_analysis_ll":
            xpad = F.pad(x[:, None], (4, 1, 4, 1), mode="circular")
            library = lambda xpad=xpad: F.conv2d(xpad, w4, stride=2)  # noqa: E731
        elif name in ("dtcwt_level1_ll_y", "dtcwt_level1_ll_color"):  # over the lincombed planes
            xp = x.permute(0, 3, 1, 2)
            chans = [_lincomb(xp, ch) for ch in range(1 if name.endswith("_y") else 2)]
            xpad = F.pad(torch.cat(chans)[:, None], (4, 1, 4, 1), mode="circular")
            library = lambda xpad=xpad: F.conv2d(xpad, w4, stride=2)  # noqa: E731
        elif name == "dtcwt_qshift_analysis":
            xpad = F.pad(x, (13, 0, 13, 0), mode="circular")
            library = lambda xpad=xpad: F.conv2d(xpad, wq16, stride=2, groups=4)  # noqa: E731
        elif name.startswith("dtcwt_legall_synthesis"):  # the roll as a window of the output
            xpad = F.pad(x, (1, 2, 1, 2), mode="circular")
            library = lambda xpad=xpad, wt=wsyn[name], hh=x.shape[-2], ww=x.shape[-1]: (  # noqa: E731
                F.conv_transpose2d(xpad, wt, stride=2)[:, 0, 5:5 + 2 * hh, 5:5 + 2 * ww])
        elif name.startswith("dtcwt_qshift_synthesis"):  # tree-major planes, the roll in the crop
            xpad = F.pad(x[:, tree_major] if x.shape[1] == 16 else x, (7, 7, 7, 7),
                         mode="circular")
            library = lambda xpad=xpad, wt=wsyn[name], hh=x.shape[-2], ww=x.shape[-1]: (  # noqa: E731
                F.conv_transpose2d(xpad, wt, stride=2, groups=4)[..., 27:27 + 2 * hh,
                                                                 27:27 + 2 * ww])
        elif name == "y_dc_mean":  # the same bytes reduced by PyTorch
            xpad, library = None, lambda x=x: x.sum(dim=(2, 3), dtype=torch.int64)  # noqa: E731
        elif name == "dtcwt_delta_synthesis":  # the chain of the three kernels it fuses
            xpad = torch.cat([torch.zeros_like(x[:, :4]), x], dim=1)
            library = lambda xpad=xpad: ds.dtcwt_legall_synthesis_ll(  # noqa: E731
                ds.dtcwt_qshift_synthesis_ll(ds.dtcwt_qshift_synthesis(xpad)))
        else:
            xpad, library = None, None
        yardstick = ("three-kernel chain" if name == "dtcwt_delta_synthesis"
                     else "int64 sum" if name == "y_dc_mean"
                     else "contiguous copy" if xpad is None and library is not None
                     else None if library is None else "library")
        yard_note = "" if library is None or "synthesis" not in name else (  # same layout
            f"; the {yardstick} differs by {float((library() - got).abs().max()):.3g}")
        run = lambda kernel=kernel, args=args: kernel(*args)  # noqa: E731
        timer = ((lambda fn, iters: _flushed_ms(fn, iters, flush)) if name in L2_FLUSHED
                 else _time_ms)
        ms = (timer(run, cfg["iters"]) + timer(run, cfg["iters"])) / 2
        # units: output positions of all 16 planes (the analyses), of the 4
        # (8) lowpass planes (the u8 lowpasses), mask positions of all 6
        # bands (masks), output samples (the syntheses), 8x8 tiles (the mark)
        if base in ("fused_mark_planar", "fused_dct_qim_mark"):  # and the means
            fb, _, fh, fw = x.shape
            units, nbytes = fb * (fh // 8) * (fw // 8), 2 * x.numel() + 4 * args[1].numel()
            nbytes += 4 * fb if name == "fused_dct_qim_mark" else 0
        elif name in ("y_dc_mean", "fused_dct_qim_extract"):  # one read, bits and means out
            fb, _, fh, fw = x.shape
            tiles = fb * (fh // 8) * (fw // 8)
            units = fb * fh * fw if name == "y_dc_mean" else tiles
            nbytes = x.numel() + 4 * fb + (4 * tiles if name != "y_dc_mean" else 0)
        elif base == "fused_extract_planar":  # one read of the frame, a bit a tile out
            units = x.shape[0] * (x.shape[2] // 8) * (x.shape[3] // 8)
            nbytes = x.numel() + 4 * units
        elif name.startswith("qim_"):  # 4x4 blocks: the blocks read, the outputs (and bits)
            units = x.shape[0] * x.shape[2]
            nbytes = (4 * x.numel() + sum(4 * g.numel() for g in gots)
                      + (4 * x.shape[2] if name == "qim_embed_soa" else 0))
        else:
            units = got.numel() // {"dtcwt_qshift_masks": 6, "dtcwt_level1_analysis": 16,
                                    "dtcwt_qshift_analysis": 16, "dtcwt_level1_ll_y": 4,
                                    "dtcwt_level1_ll_color": 8}.get(name, 1)
            # a strided input read in place: the bytes of the rows it touches
            nbytes = (x.element_size() * x.numel() * x.stride(-1)
                      + got.element_size() * got.numel())
        t = timing_entry(ms, None, library, run, nbytes, units * FLOPS_PER_UNIT[name],
                         cfg["iters"], timer=timer)
        cold = None if name not in L2_FLUSHED + FLAGSHIP_BODIES else (
            _cold_graph_ms(run, cfg["iters"], flush) + _cold_graph_ms(run, cfg["iters"], flush)) / 2
        del xpad, library, got, want, gots, wants
        view = (" (means taken in the same read, two launches)"
                if name == "fused_dct_qim_extract" else "") + (
            "" if x.is_contiguous() else
            " (interleaved view)" if name.startswith("fused") or name == "y_dc_mean" else
            " (Y view of interleaved YUV)" if name == "dtcwt_level1_analysis_ll"
            else " (batch-strided view)")
        print("sweep " + timing_line(name, x.shape, t, x.shape[0])[len("timing "):] + view
              + yard_note + ("" if cold is None else
                             (" [L2 flushed before each timed launch; " if name in L2_FLUSHED
                              else " [") + f"device only with a cold, clean L2 {cold:.4f} ms, "
                             f"{t['bound_ms'] / cold:.1%} of the bound]"))
        if occupancy:
            print(occupancy_line(name, x, report))
        split = device_split(run) if name in ("y_dc_mean", "fused_dct_qim_extract") else None
        if split:
            print(f"split {name} @ {tuple(x.shape)}{view}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) + " (device, profiler)")
        entries[name].append({"shape": list(x.shape), "max_abs_err": err,
                              "strided": not x.is_contiguous(), "yardstick": yardstick,
                              **({"split_ms": split} if split else {}),
                              **({"cold_device_ms": cold} if cold is not None else {}),
                              **{k: t[k] for k in ("ms", "device_ms", "library_ms",
                                                   "library_device_ms", "bound_ms", "bound_by")}})
    return dict(entries), dict(errs)


def time_batch_stages(device, cfg, reps: int = 5) -> None:
    """Host clock around one 16-frame batch of FrameMarker/FrameExtractor's
    work, split at its synchronising boundaries: upload (pinned staging +
    H2D), device compute, download (``pipeline/transfer.py:download``, the
    pipeline's own: a non-blocking copy into pinned memory, waited on).  Median of ``reps`` after a
    warm-up.  1080p for every codec, 1920x804 (path 1) and float frames
    (path 2) for ``dtcwtKey``.  Then two whole calls of the flagship codec
    at 1080p: ``FrameMarker.mark`` and ``MultiMarker.mark_all`` with 3
    variants."""
    from vfp_tpu_torch.pipeline.embedder import upload_batch
    from vfp_tpu_torch.pipeline.transfer import download
    from vfp_tpu_torch.wm import DctQim, DeCorrShuffler, DeShuffler, DtcwtKey, DwtDctSvd

    rng = np.random.RandomState(5)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    frames = natural_frames(rng, b, h, w)
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    stages = {}
    for label, codec in (("", DwtDctSvd()), ("dct ", DctQim())):
        wm = spread_wm(codec, h, w, device)
        stages[label + "mark"] = (frames, lambda x, c=codec, wm=wm: c.mark_frames(x, wm))
        stages[label + "extract"] = (frames,
                                     lambda x, c=codec: deg.degenerate_batch(c.extract_frames(x)))
    key_codec = DtcwtKey()
    deg_key = DeCorrShuffler(0)  # one per run, as the CLI: its keyed plane is made once
    scope = smooth_frames(rng, b, cfg["scope_h"], w)
    for label, fr in (("dtcwtKey", frames), ("dtcwtKey 1920x804", scope)):
        wm_key = key_wm(key_codec, fr.shape[1], w, device)
        stages[label + " mark"] = (fr, lambda x, wm=wm_key: key_codec.mark_frames(x, wm))
        stages[label + " extract"] = (fr, lambda x: deg_key.correlation_batch(
            key_codec.extract_frames(x)))
    # path 2's float frames: u8 uploaded, made float32 on the card (in the
    # device stage), then the bgr_to_yuv channel path
    wm_key = key_wm(key_codec, h, w, device)
    stages["dtcwtKey float mark"] = (frames, lambda x: key_codec.mark_frames(
        x.to(torch.float32), wm_key))
    stages["dtcwtKey float extract"] = (frames, lambda x: deg_key.correlation_batch(
        key_codec.extract_frames(x.to(torch.float32))))
    for name, (host, compute) in stages.items():
        runs = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            x = upload_batch(host, b, device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = compute(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            download([y], b).wait()
            t3 = time.perf_counter()
            runs.append((t1 - t0, t2 - t1, t3 - t2))
        up, dev, down = (1e3 * float(np.median(col)) for col in zip(*runs[1:]))
        print(f"batch stages {name} @ {b}x{host.shape[1]}x{host.shape[2]}: upload {up:.3f} ms, "
              f"device {dev:.3f} ms, download {down:.3f} ms (host clock, median of {reps})")
    # whole calls, as a pipeline makes them: the host frames in, the marked
    # frames on the host out (FrameMarker and MultiMarker exist in the parent
    # commit too, so --package-root times the transfers before and after)
    from vfp_tpu_torch.pipeline import FrameMarker, MultiMarker
    from vfp_tpu_torch.wm import Shuffler

    codec = DwtDctSvd()
    wms = [np.asarray(Shuffler(key=k).generate_wm(np.array([int(c) for c in PAYLOAD]),
                                                  codec.wm_capacity((h, w, 3))), np.float32)
           for k in range(3)]
    calls = {"FrameMarker.mark": (FrameMarker(codec, wms[0], b, device=device).mark, 1),
             "MultiMarker.mark_all (3 variants)": (
                 MultiMarker(codec, wms, b, device=device).mark_all, 3)}
    for name, (call, variants) in calls.items():
        runs = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(frames)  # ends with the marked frames on the host
            runs.append(time.perf_counter() - t0)
        ms = 1e3 * float(np.median(runs[1:]))
        split = device_split(lambda call=call: call(frames), calls=3)
        print(f"batch call {name} @ {b}x{h}x{w}: {ms:.3f} ms whole call "
              f"({variants * b / ms * 1e3:.1f} variant-frames/s; host clock, median of {reps}); "
              f"device ms a call: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + " (profiler)")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="only the build and redesign_sweep (the kernels redesigned for "
                         "Hopper: level-1 and q-shift analysis, the LeGall and q-shift "
                         "syntheses, the masks, the delta, the level-1 u8 and f32 lowpasses, "
                         "the flagship and DCT-QIM marks, the Y mean and the DCT-QIM extract, "
                         "the QIM kernels and the flagship extract, the flagship kernels' "
                         "integer bodies, at every shape the paths give them)")
    ap.add_argument("--stages", action="store_true",
                    help="only the build and the batch stages (upload, device, download of "
                         "one batch of each codec's pipeline work)")
    ap.add_argument("--sass", metavar="PATTERN", default=None,
                    help="only the build and the SASS opcode histogram of the kernels whose "
                         "mangled name contains PATTERN (cuobjdump)")
    ap.add_argument("--only", metavar="PATTERN", default=None,
                    help="with --sweep: only the kernels whose name contains PATTERN (or one "
                         "of its comma-separated parts)")
    ap.add_argument("--package-root", type=Path, default=None,
                    help="with --sweep, --stages or --sass: import vfp_tpu_torch from this "
                         "checkout (e.g. the parent commit unpacked with git archive) instead "
                         "of this one")
    args = ap.parse_args(argv)
    if args.package_root is not None:
        if not (args.sweep or args.stages or args.sass is not None):
            ap.error("--package-root needs --sweep, --stages or --sass")
        sys.path.insert(0, str(args.package_root.resolve()))
    if args.only is not None and not args.sweep:
        ap.error("--only needs --sweep")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = FULL
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    card = f"[{smi}]"
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"nvidia-smi: {smi}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    from vfp_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s to a loaded library "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'not run'} s) "
          f"in {_build.BUILD_ROOT}")
    for line in ptxas_summary(_build.build_log):
        print(f"build: ptxas {line}")
    if args.sweep:
        sweep, _ = redesign_sweep(device, cfg, occupancy=args.package_root is None,
                                  only=args.only)
        print(f"sweep above on {card}, package {Path(_build.__file__).parents[1]}")
        print(json.dumps({"sweep": sweep}))
        return 0
    if args.sass is not None:
        for line in sass_report(_build.BUILD_ROOT / _build.source_hash() / _build.LIB_NAME,
                                args.sass):
            print(line)
        print(f"sass above, package {Path(_build.__file__).parents[1]}")
        return 0
    if args.stages:
        time_batch_stages(device, cfg)
        print(f"batch stages above on {card}, package {Path(_build.__file__).parents[1]}")
        return 0
    workroot = ROOT / "build" / "chip_smoke"
    workroot.mkdir(parents=True, exist_ok=True)

    errs = check_kernels(device, cfg)
    counts = collections.Counter()  # each path's launches, zeroed before it and read after
    with tempfile.TemporaryDirectory(dir=workroot) as tmp:
        flagship, source_1080p = run_main_path(device, cfg, Path(tmp))
        counts.update(flagship)
        counts.update(run_dct_path(device, cfg, Path(tmp), source_1080p))
        dtcwt, smooth_1080p = run_dtcwt_path(device, cfg, Path(tmp))
        counts.update(dtcwt)
        counts.update(run_dtcwt_scope_path(device, cfg, Path(tmp)))
        counts.update(run_dtcwt_float_path(device, cfg))
        counts.update(run_dtcwt_depth_path(device, cfg, Path(tmp), smooth_1080p))
        hls_counts, hls_stats = run_hls_path(device, cfg, Path(tmp))
        counts.update(hls_counts)
        counts.update(run_serve_path(device, cfg, Path(tmp)))
        counts.update(run_dtcwt_img_path(device, cfg, Path(tmp)))
        durability, smooth_180 = run_durability_path(device, cfg, Path(tmp))
        counts.update(durability)
        counts.update(run_media_path(device, cfg, Path(tmp), smooth_180))
        smooth_180.unlink()
        counts.update(run_ffmpeg_path(device, cfg, Path(tmp), hls_counts))
        counts.update(run_lowlink_path(device, cfg, Path(tmp), source_1080p, hls_stats))
        int_counts, int_errs = run_int_path(device, cfg, smooth_1080p)
        counts.update(int_counts)
        errs.update(int_errs)
        counts.update(run_parallel_path(device, cfg, Path(tmp), hls_stats))
    from vfp_tpu_torch.kernels import EXTRACT_DECIDE

    assert all(counts[k] > 0 for k in (*REPLACES, EXTRACT_DECIDE)), counts  # every kernel
    # the spectrum once per distinct plane: 1080p and 1920x804 CLI mark 1 each,
    # the float path 1, path 3 two per batch and 1, the round trip 1, the
    # dtcwtImg CLI marks 1 each, durability's dtcwtKey run 1 per segment key,
    # the sharded dtcwtKey mark 1 per variant
    assert counts["dtcwt_level1_analysis"] == 19, counts
    times = time_kernels(device, cfg)
    sweep, sweep_errs = redesign_sweep(device, cfg)
    for name, err in sweep_errs.items():
        errs[name] = max(errs[name], err)
    time_batch_stages(device, cfg)
    print(f"timings above on {card}")

    keys = ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"vfp_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": counts[name], "max_abs_err": errs[name],
         **{k: times[name][k] for k in keys}, **({"shapes": sweep[name]} if name in sweep else {})}
        for name, (src, replaces) in REPLACES.items()]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the device check to the "
          f"kernels line")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
