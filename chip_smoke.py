#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vfp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing its lines:

1. device: the card's name and power limit (nvidia-smi); exits nonzero when
   torch sees no CUDA device — there is no CPU path;
2. build: compiles ``vfp_tpu_torch/csrc/*.cu`` with nvcc into
   ``build/vfp_tpu_torch/`` and prints the seconds;
3. kernels: each of the sixteen CUDA kernels against its plain PyTorch
   version on the card, at the main paths' shapes (1080p B=16) and at edge
   shapes (W=856, H=1078, N not a multiple of 32, flat 8x8 blocks whose
   texture mask divides 0/0, a black frame whose DT-CWT masks and delta are
   0), within the stated tolerances; the masks and the q-shift level also on
   the in-place halves of the detect path's level-1 output;
4. main paths, each with the launch counts set to 0 just before it and read
   just after: the flagship codec's ``python -m vfp_tpu_torch.cli mark``
   then ``detect --payload`` on a 48-frame 1920x1080 .rawv (fused kernels),
   the same at 1918x1080 (W % 4 != 0: the SoA kernels), and a two-channel
   codec through the pipeline API (``qim_embed_soa``); then ``mark --codec
   dct`` and ``detect --codec dct`` on the 1920x1080 file (the DCT-QIM
   kernels and the Y-mean pre-pass); then ``mark --codec dtcwtKey`` on a
   48-frame 1920x1080 .rawv of smooth content (the four DT-CWT mark
   kernels), then ``detect --codec dtcwtKey`` on the card (the four detect
   kernels and the masks), which must find the mark with key 0 in 48/48
   frames and with key 99 in 0/48, and agree with the plain kernel path on
   the card.  The counts must show every kernel ran and no plain version may
   see a CUDA tensor;
5. timings: ms per 16-frame 1080p batch and frames/s, kernel vs plain version
   (and one PyTorch library call where one computes the same function),
   with CUDA events after warm-up, beside the bound the card's HBM rate and
   float32 peak set for the same work; then one batch of each codec's
   pipeline work split into upload, device and download on the host clock.

Then one JSON line per the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits nonzero.
The work files go under ``build/chip_smoke/`` and are removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
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
        "prime_w": 856, "prime_h": 480, "iters": 20}
ALPHA = 20.0  # the DCT-QIM codec's default
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
    "qim_triplet_soa": 770,  # Gram 112, 5 normalisations and 4 4x4 squarings, v, s0, u
    "qim_decode_soa": 773,
    "qim_embed_soa": 825,  # triplet + QIM + 16-entry rank-1 update
    # Y and U lincombs 64 x 2 x 6, row pass 64 x 15 + 8 x 15, column pass 64 x 15,
    # v 15, masks 167, QIM 10, epilogue 64 x 11
    "fused_dct_qim_mark": 3704,
    "fused_dct_qim_extract": 3003,
    "y_dc_mean": 7,  # lincomb 6 + one float64 add
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


def ptxas_summary(log: str) -> list[str]:
    """'<source> <kernel>[<packed|strided>]: N registers, S bytes spilled' per
    kernel, from the build's ``-Xptxas=-v`` report."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            src = re.search(r"_\d+_(\w+?)_cu_", mangled)
            fn = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            name = (f"{src.group(1) if src else '?'}.cu "
                    f"{mangled[fn.end():fn.end() + int(fn.group(1))] if fn else mangled}")
            if "ILb1E" in mangled or "ILb0E" in mangled:
                name += "[packed]" if "ILb1E" in mangled else "[strided]"
            spill = 0
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(f"{name}: {regs} registers, {spill} bytes spilled")
            name = None
    return out or ["report not available (library loaded from disk)"]


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
    from vfp_tpu_torch.ops.soa import image_to_soa
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
        # borderline s0 may take the other, parity-equivalent QIM bin
        assert same >= 0.995, f"fused_mark_planar {b}x{h}x{w}: {same:.5f} identical"
        assert torch.equal(got[:, :, 8 * nbh:], planes[:, :, 8 * nbh:]), "tail rows modified"
        bits = fe.fused_extract_planar(got, 15.0, 1)
        torch.cuda.synchronize()
        want_bits = fe.fused_extract_planar_reference(got, 15.0, 1)
        record("fused_extract_planar", (bits - want_bits).abs().max())
        assert _frac_equal(bits, want_bits) >= 0.999, f"fused_extract_planar {b}x{h}x{w}"
        assert_payload(bits.reshape(b, -1), codec.wm_capacity((h, w, 3))[1])
        print(f"kernels: fused mark/extract {b}x{h}x{w}: {same:.6f} of pixels identical, "
              f"{_frac_equal(bits, want_bits):.6f} of bits identical")

    soa_inputs = []
    for b, h, w in [(cfg["b"], cfg["h"], cfg["narrow_w"]), (cfg["b"], cfg["h"], cfg["w"])]:
        frames = torch.as_tensor(natural_frames(rng, b, h, w), device=device)
        (nbh, nbw), _ = block_grid((h, w))
        ll = codec._ll_from_frames(frames.to(torch.float32), 1)
        soa_inputs.append(image_to_soa(ll[:, : 4 * nbh, : 4 * nbw], 4))
    soa_inputs.append(torch.as_tensor(rng.rand(2, 16, 700).astype(np.float32) * 300,
                                      device=device))
    for m in soa_inputs:
        n = m.shape[2]
        s0, u, v = qim.qim_triplet_soa(m)
        torch.cuda.synchronize()
        ws0, wu, wv = qim.qim_triplet_soa_reference(m)
        rank1 = (u[:, :, None] * v[:, None] - wu[:, :, None] * wv[:, None]).abs().max()
        record("qim_triplet_soa", max(float((s0 - ws0).abs().max()), float(rank1)))
        assert torch.allclose(s0, ws0, rtol=2e-5, atol=0), f"qim_triplet_soa s0, N={n}"
        assert float(rank1) <= 2e-5, f"qim_triplet_soa u vT, N={n}: {float(rank1)}"

        bits = qim.qim_decode_soa(m, 15.0)
        torch.cuda.synchronize()
        want_bits = qim.qim_decode_soa_reference(m, 15.0)
        record("qim_decode_soa", (bits - want_bits).abs().max())
        assert _frac_equal(bits, want_bits) >= 0.999, f"qim_decode_soa N={n}"

        wm = torch.as_tensor(rng.randint(0, 2, n).astype(np.float32), device=device)
        marked = qim.qim_embed_soa(m, wm, 15.0)
        torch.cuda.synchronize()
        want = qim.qim_embed_soa_reference(m, wm, 15.0)
        record("qim_embed_soa", (marked - want).abs().max())
        # per block: equal to f32 noise, or a borderline block in the other bin
        close = ((marked - want).abs() <= 1e-3).all(dim=1).float().mean()
        assert float(close) >= 0.999, f"qim_embed_soa N={n}: {float(close):.5f} of blocks"
        print(f"kernels: SoA triplet/decode/embed N={n}: s0 max err "
              f"{float((s0 - ws0).abs().max()):.3g}, bits "
              f"{_frac_equal(bits, want_bits):.6f} identical")
    check_dct_kernels(device, cfg, rng, record)
    check_dtcwt_kernels(device, cfg, rng, record)
    return err


def _with_flat_blocks(frames):
    """Black, white and mid-grey 8x8-aligned fields: their texture-mask
    divisions are 0/0 and x/0, and IEEE comparisons decide the branches."""
    frames[:, 0:200] = 0
    frames[:, 200:400] = 255
    frames[:, 400:600, : frames.shape[2] // 2] = 128
    return frames


def check_dct_kernels(device, cfg, rng, record):
    """The DCT-QIM kernels and the Y mean against their plain versions; mark
    and extract get the same means as their plain versions."""
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
            assert torch.allclose(means, want_means, rtol=1e-6, atol=0), (means, want_means)
            wm2d = torch.as_tensor(rng.randint(0, 2, (h // 8, w // 8)).astype(np.float32),
                                   device=device)
            got = dq.fused_dct_qim_mark(planes, wm2d, ALPHA, means)
            torch.cuda.synchronize()
            want = dq.fused_dct_qim_mark_reference(planes, wm2d, ALPHA, means)
            same = _frac_equal(got, want)
            record("fused_dct_qim_mark", (got.int() - want.int()).abs().max())
            assert same >= 0.999, f"fused_dct_qim_mark {b}x{h}x{w}: {same:.6f} identical"
            assert got.stride() == planes.stride()
            bits = dq.fused_dct_qim_extract(got, ALPHA, means)
            torch.cuda.synchronize()
            want_bits = dq.fused_dct_qim_extract_reference(got, ALPHA, means)
            record("fused_dct_qim_extract", (bits - want_bits).abs().max())
            assert _frac_equal(bits, want_bits) >= 0.999, f"fused_dct_qim_extract {b}x{h}x{w}"
            if not flat:  # a flat field clips at 0 and 255 and cannot carry every bit
                assert _frac_equal(bits, wm2d.expand_as(bits)) >= 0.999, "bits not embedded"
            print(f"kernels: DCT-QIM mark/extract {b}x{h}x{w}{' flat' if flat else ''} "
                  f"{'interleaved' if planes.stride(1) == 1 else 'planar'}: {same:.6f} of "
                  f"pixels identical, {_frac_equal(bits, want_bits):.6f} of bits identical, "
                  f"means max rel err "
                  f"{float(((means - want_means).abs() / want_means.abs()).max()):.3g}")


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
        assert torch.allclose(ll, want_ll, rtol=1e-6, atol=1e-4), "dtcwt_level1_ll_y"
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
        assert torch.allclose(du, want_du, rtol=1e-5, atol=1e-4), "dtcwt_delta_synthesis"
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
    assert torch.allclose(ll, want, rtol=1e-6, atol=1e-4), "dtcwt_level1_ll_color"
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

    kernels.reset_launch_counts()
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
    kernels.reset_launch_counts()
    with NoPlainOnDevice():
        cli(["mark", str(source), str(out), *flags])
        cli(["detect", str(out), "--payload", PAYLOAD, *flags])  # exits 1 on a wrong payload
    counts = kernels.launch_counts()
    want = {"fused_dct_qim_mark": batches, "fused_dct_qim_extract": batches,
            "y_dc_mean": 2 * batches}
    assert all(counts[k] == v for k, v in want.items()), (counts, want)
    assert not any(counts[k] for k in REPLACES if k not in want), counts
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


def plain_dtcwt_mark(codec, frames, wm):
    """The kernel path's mark with every kernel replaced by its plain version."""
    from vfp_tpu_torch.kernels import dtcwt_delta as dd, dtcwt_level1 as dl, dtcwt_masks as dm
    from vfp_tpu_torch.ops.color import M_BWD
    from vfp_tpu_torch.ops.dtcwt import Transform2d

    h, w = frames.shape[1], frames.shape[2]
    wm_hp = Transform2d("torch").forward(wm.reshape(codec.wm_capacity((h, w, 3))),
                                         nlevels=1).highpasses[0]
    masks = dm.dtcwt_qshift_masks_reference(dl.dtcwt_level1_ll_y_reference(frames), codec.step)
    du = dd.dtcwt_delta_synthesis_reference(codec._delta_subs(masks, wm_hp))
    marked = frames.to(torch.float32) + du[..., None] * torch.as_tensor(M_BWD[:, 1],
                                                                       device=frames.device)
    return torch.round(torch.clamp(marked, 0.0, 255.0)).to(torch.uint8)


def plain_dtcwt_extract(codec, frames):
    """The kernel path's extract with every kernel replaced by its plain version."""
    from vfp_tpu_torch.kernels import dtcwt_level1 as dl, dtcwt_masks as dm
    from vfp_tpu_torch.kernels import dtcwt_synthesis as ds

    ll = dl.dtcwt_level1_ll_color_reference(frames)
    u_hp3 = dl.dtcwt_qshift_hp_reference(dl.dtcwt_qshift_ll_reference(ll[:, 1]))
    masks = dm.dtcwt_qshift_masks_reference(ll[:, 0], codec.step)
    return codec._decode_coeffs(u_hp3, masks, ds.dtcwt_legall_synthesis_hp_reference)


def _cli_lines(cli, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(argv)
    return out.getvalue()


def run_dtcwt_path(device, cfg, workdir: Path) -> dict:
    """``cli mark --codec dtcwtKey`` on a 48-frame smooth 1920x1080 file, then
    ``cli detect --codec dtcwtKey`` on the card with key 0 (48/48 present)
    and key 99 (0/48); the first batch's correlations against the plain
    kernel path on the card, and the port's tensor-path extract (CPU) on two
    frames.  Returns the launch counts of the mark run plus the key-0 detect
    run, each counted alone."""
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
    kernels.reset_launch_counts()
    with NoPlainOnDevice():
        cli(["mark", str(source), str(out), *flags])
    counts = kernels.launch_counts()
    assert all(counts[k] == batches for k in DTCWT), counts
    assert not any(counts[k] for k in REPLACES if k not in DTCWT), counts
    mark_counts = {k: counts[k] for k in DTCWT}
    print(f"main path dtcwtKey {w}x{h}: {n} frames marked, launches {mark_counts}")

    def detect(key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = _cli_lines(cli, ["detect", str(out), "--key", str(key), *flags])
        return text, time.perf_counter() - t0

    kernels.reset_launch_counts()
    with NoPlainOnDevice():
        lines, seconds = detect(0)
    counts = kernels.launch_counts()
    assert all(counts[k] == batches for k in DTCWT_DETECT), counts
    assert not any(counts[k] for k in REPLACES if k not in DTCWT_DETECT), counts
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
    want = plain_dtcwt_mark(codec, x, key_wm(codec, h, w, device)).cpu().numpy()
    same = float((want == marked[: cfg["b"]]).mean())
    assert same >= 0.995, same
    first = torch.as_tensor(np.array(marked[: cfg["b"]]), device=device)
    deg = DeCorrShuffler(0)
    got_corr = deg.correlation_batch(codec.extract_frames(first))
    want_corr = deg.correlation_batch(plain_dtcwt_extract(codec, first))
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
    return {**mark_counts, **detect_counts,
            "dtcwt_qshift_masks": mark_counts["dtcwt_qshift_masks"]
            + detect_counts["dtcwt_qshift_masks"]}


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


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    mem, ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def time_kernels(device, cfg) -> dict:
    """{name: (kernel ms, plain ms, library ms or None, bound ms, bound_by)}."""
    from vfp_tpu_torch.kernels import fused_dct_qim as dq
    from vfp_tpu_torch.kernels import fused_embed as fe
    from vfp_tpu_torch.kernels import qim
    from vfp_tpu_torch.ops.soa import image_to_soa
    from vfp_tpu_torch.wm import DwtDctSvd, block_grid

    rng = np.random.RandomState(3)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    codec = DwtDctSvd()
    frames = torch.as_tensor(natural_frames(rng, b, h, w), device=device)
    planes = frames.permute(0, 3, 1, 2)
    (nbh, nbw), _ = block_grid((h, w))
    wm2d = spread_wm(codec, h, w, device)[: nbh * nbw].reshape(nbh, nbw).contiguous()
    # the SoA kernels at the blocks the main path gives them: W % 4 != 0 frames
    narrow = torch.as_tensor(natural_frames(rng, b, h, cfg["narrow_w"]), device=device)
    (nbh, nbw), _ = block_grid((h, cfg["narrow_w"]))
    ll = codec._ll_from_frames(narrow.to(torch.float32), 1)
    m = image_to_soa(ll[:, : 4 * nbh, : 4 * nbw], 4)
    wm = torch.as_tensor(np.random.RandomState(4).randint(0, 2, m.shape[2]).astype(np.float32),
                         device=device)
    wm_dct = torch.as_tensor(np.random.RandomState(6).randint(0, 2, (h // 8, w // 8)).astype(
        np.float32), device=device)
    means = dq.y_dc_mean(planes)
    dt_cases, dt_library, dt_work, dt_shapes = dtcwt_timing_cases(device, cfg, rng)
    cases = {
        "fused_mark_planar": (lambda: fe.fused_mark_planar(planes, wm2d, 15.0, 1),
                              lambda: fe.fused_mark_planar_reference(planes, wm2d, 15.0, 1)),
        "fused_extract_planar": (lambda: fe.fused_extract_planar(planes, 15.0, 1),
                                 lambda: fe.fused_extract_planar_reference(planes, 15.0, 1)),
        "qim_triplet_soa": (lambda: qim.qim_triplet_soa(m),
                            lambda: qim.qim_triplet_soa_reference(m)),
        "qim_decode_soa": (lambda: qim.qim_decode_soa(m, 15.0),
                           lambda: qim.qim_decode_soa_reference(m, 15.0)),
        "qim_embed_soa": (lambda: qim.qim_embed_soa(m, wm, 15.0),
                          lambda: qim.qim_embed_soa_reference(m, wm, 15.0)),
        "fused_dct_qim_mark": (lambda: dq.fused_dct_qim_mark(planes, wm_dct, ALPHA, means),
                               lambda: dq.fused_dct_qim_mark_reference(planes, wm_dct, ALPHA,
                                                                       means)),
        "fused_dct_qim_extract": (lambda: dq.fused_dct_qim_extract(planes, ALPHA, means),
                                  lambda: dq.fused_dct_qim_extract_reference(planes, ALPHA,
                                                                             means)),
        "y_dc_mean": (lambda: dq.y_dc_mean(planes), lambda: dq.y_dc_mean_reference(planes)),
        **dt_cases,
    }
    # one PyTorch call that computes the same function, where there is one: the
    # dominant triplet is the first singular triplet of each 4x4 block
    blocks4 = m.permute(0, 2, 1).reshape(-1, 4, 4)
    library = {"qim_triplet_soa": lambda: torch.linalg.svd(blocks4), **dt_library}
    frame_bytes, soa_bytes = planes.numel(), 4 * m.numel()
    nb, ns, tiles = (h // 8) * (w // 8), m.shape[0] * m.shape[2], b * (h // 8) * (w // 8)
    work = {  # (bytes each input read once and each output written once, FLOPs)
        "fused_mark_planar": (2 * frame_bytes + 4 * wm2d.numel(), tiles),
        "fused_extract_planar": (frame_bytes + 4 * tiles, tiles),
        "qim_triplet_soa": (soa_bytes + 4 * 9 * ns, ns),
        "qim_decode_soa": (soa_bytes + 4 * ns, ns),
        "qim_embed_soa": (2 * soa_bytes + 4 * m.shape[2], ns),
        "fused_dct_qim_mark": (2 * frame_bytes + 4 * nb + 4 * b, tiles),
        "fused_dct_qim_extract": (frame_bytes + 4 * tiles + 4 * b, tiles),
        "y_dc_mean": (frame_bytes + 4 * b, b * h * w),
        **dt_work,
    }
    shapes = {name: (m.shape if name.startswith("qim") else planes.shape) for name in cases}
    shapes.update(dt_shapes)
    times = {}
    for name, (kernel, plain) in cases.items():
        # plain, kernel, kernel, plain: the median of each pair of turns
        p1 = _time_ms(plain, max(2, cfg["iters"] // 4))
        k1 = _time_ms(kernel, cfg["iters"])
        k2 = _time_ms(kernel, cfg["iters"])
        p2 = _time_ms(plain, max(2, cfg["iters"] // 4))
        lib = _time_ms(library[name], 2) if name in library else None
        nbytes, units = work[name]
        bound_ms, bound_by = bound(nbytes, units * FLOPS_PER_UNIT[name])
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, lib, bound_ms, bound_by)
        print(f"timing {name} @ {tuple(shapes[name])}: kernel {times[name][0]:.4f} ms/batch "
              f"({b / times[name][0] * 1e3:.1f} frames/s), plain {times[name][1]:.4f} ms/batch "
              f"({b / times[name][1] * 1e3:.1f} frames/s), library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, {units * FLOPS_PER_UNIT[name] / 1e9:.3f} "
              f"GFLOP), kernel at {bound_ms / times[name][0]:.1%} of the bound")
    return times


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


def _legall_hp_weights() -> torch.Tensor:
    """[12, 1, 6, 6] conv_transpose2d weights of the highpass-only LeGall
    synthesis, planes [lh*4, hl*4, hh*4]: tree (rt, ct)'s sampling phase
    shifts the taps, w[rt + kr][ct + kc] = 0.25 * fr[kr] * fc[kc], with rows
    g0 (lh) or g1 (hl, hh) and columns g1 (lh, hh) or g0 (hl)."""
    from vfp_tpu_torch.ops import dtcwt_coeffs as C

    ws = []
    for fr, fc in ((C.LEGALL_G0, C.LEGALL_G1), (C.LEGALL_G1, C.LEGALL_G0),
                   (C.LEGALL_G1, C.LEGALL_G1)):
        for rt in range(2):
            for ct in range(2):
                wt = np.zeros((6, 6), np.float32)
                for kr, a in enumerate(fr):
                    for kc, c in enumerate(fc):
                        wt[rt + kr, ct + kc] = np.float32(0.25) * np.float32(a) * np.float32(c)
                ws.append(wt)
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
    wsyn = _legall_hp_weights().to(device)
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


def time_batch_stages(device, cfg, reps: int = 5) -> None:
    """Host clock around one 16-frame 1080p batch of FrameMarker/FrameExtractor's
    work, split at its synchronising boundaries: upload (pinned staging +
    H2D), device compute, download.  Median of ``reps`` after a warm-up."""
    from vfp_tpu_torch.pipeline.embedder import upload_batch
    from vfp_tpu_torch.wm import DctQim, DeCorrShuffler, DeShuffler, DtcwtKey, DwtDctSvd

    rng = np.random.RandomState(5)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    frames = natural_frames(rng, b, h, w)
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    stages = {}
    for label, codec in (("", DwtDctSvd()), ("dct ", DctQim())):
        wm = spread_wm(codec, h, w, device)
        stages[label + "mark"] = (lambda x, c=codec, wm=wm: c.mark_frames(x, wm))
        stages[label + "extract"] = (lambda x, c=codec: deg.degenerate_batch(c.extract_frames(x)))
    key_codec = DtcwtKey()
    wm_key = key_wm(key_codec, h, w, device)
    stages["dtcwtKey mark"] = lambda x: key_codec.mark_frames(x, wm_key)
    deg_key = DeCorrShuffler(0)  # one per run, as the CLI: its keyed plane is made once
    stages["dtcwtKey extract"] = lambda x: deg_key.correlation_batch(key_codec.extract_frames(x))
    for name, compute in stages.items():
        runs = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            x = upload_batch(frames, b, device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = compute(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            y.cpu().numpy()
            t3 = time.perf_counter()
            runs.append((t1 - t0, t2 - t1, t3 - t2))
        up, dev, down = (1e3 * float(np.median(col)) for col in zip(*runs[1:]))
        print(f"batch stages {name} @ {b}x{h}x{w}: upload {up:.3f} ms, device {dev:.3f} ms, "
              f"download {down:.3f} ms (host clock, median of {reps})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = FULL

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

    errs = check_kernels(device, cfg)
    workroot = ROOT / "build" / "chip_smoke"
    workroot.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workroot) as tmp:
        counts, source_1080p = run_main_path(device, cfg, Path(tmp))
        counts.update(run_dct_path(device, cfg, Path(tmp), source_1080p))
        counts.update(run_dtcwt_path(device, cfg, Path(tmp)))
    times = time_kernels(device, cfg)
    time_batch_stages(device, cfg)
    print(f"timings above on {card}")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"vfp_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": times[name][3],
         "bound_by": times[name][4], "library_ms": times[name][2]}
        for name, (src, replaces) in REPLACES.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
