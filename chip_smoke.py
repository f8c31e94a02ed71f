#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vfp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing its lines:

1. device: the card's name and power limit (nvidia-smi); exits nonzero when
   torch sees no CUDA device — there is no CPU path;
2. build: compiles ``vfp_tpu_torch/csrc/*.cu`` with nvcc into
   ``build/vfp_tpu_torch/`` and prints the seconds;
3. kernels: each of the five CUDA kernels against its plain PyTorch version
   on the card, at the main path's shapes (1080p B=16) and at edge shapes
   (W=856, H=1078, N not a multiple of 32), within the stated tolerances;
4. main path: ``python -m vfp_tpu_torch.cli mark`` then ``detect --payload``
   on a 48-frame 1920x1080 .rawv (fused kernels), the same at 1918x1080
   (W % 4 != 0: the SoA kernels), and a two-channel codec through the
   pipeline API (``qim_embed_soa``); launch counts must show every kernel ran
   and no plain version may see a CUDA tensor;
5. timings: ms per 16-frame 1080p batch and frames/s, kernel vs plain version,
   with CUDA events after warm-up; then one batch of the pipeline's work split
   into upload, device and download on the host clock.

Then one JSON line per the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits nonzero.
The work files go under ``build/chip_smoke/`` and are removed at the end.
"""

from __future__ import annotations

import json
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
REPLACES = {
    "fused_mark_planar": ("fused_embed.cu", "vfp_tpu/kernels/fused_embed.py:239"),
    "fused_extract_planar": ("fused_embed.cu", "vfp_tpu/kernels/fused_embed.py:338"),
    "qim_triplet_soa": ("qim.cu", "vfp_tpu/kernels/qim.py:186"),
    "qim_decode_soa": ("qim.cu", "vfp_tpu/kernels/qim.py:165"),
    "qim_embed_soa": ("qim.cu", "vfp_tpu/kernels/qim.py:138"),
}


def natural_frames(rng, b, h, w):
    """Smooth numpy content: coarse noise upsampled 8x plus mild grain."""
    small = rng.rand(b, -(-h // 8), -(-w // 8), 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)[:, :h, :w] * 220
    return np.clip(f + rng.rand(b, h, w, 3) * 20, 0, 255).astype(np.uint8)


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
    return err


# -- phase 4: the main path -------------------------------------------------------

def _write_rawv(path, rng, n, h, w, chunk=16):
    from vfp_tpu_torch.io import RawVideoWriter

    with RawVideoWriter(path, w, h, fps=24) as writer:
        for i in range(0, n, chunk):
            writer.write_batch(natural_frames(rng, min(chunk, n - i), h, w))


def _read_rawv(path):
    from vfp_tpu_torch.io import RawVideoReader

    r = RawVideoReader(path)
    try:
        return r.read_batch(10 ** 6)
    finally:
        r.close()


class NoPlainOnDevice:
    """Within the block, every plain version raises if it is given a CUDA tensor."""

    def __init__(self):
        from vfp_tpu_torch.kernels import fused_embed, qim
        from vfp_tpu_torch.wm import dwt_dct_svd

        self.targets = [(mod, name) for mod in (qim, fused_embed) for name in dir(mod)
                        if name.endswith("_reference")]
        self.targets.append((dwt_dct_svd, "top_triplet_soa"))
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
    assert all(v > 0 for v in counts.values()), counts

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


def time_kernels(device, cfg) -> dict:
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
    }
    shapes = {"fused_mark_planar": planes.shape, "fused_extract_planar": planes.shape,
              "qim_triplet_soa": m.shape, "qim_decode_soa": m.shape, "qim_embed_soa": m.shape}
    times = {}
    for name, (kernel, plain) in cases.items():
        # plain, kernel, kernel, plain: the median of each pair of turns
        p1 = _time_ms(plain, max(2, cfg["iters"] // 4))
        k1 = _time_ms(kernel, cfg["iters"])
        k2 = _time_ms(kernel, cfg["iters"])
        p2 = _time_ms(plain, max(2, cfg["iters"] // 4))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing {name} @ {tuple(shapes[name])}: kernel {times[name][0]:.4f} ms/batch "
              f"({b / times[name][0] * 1e3:.1f} frames/s), plain {times[name][1]:.4f} ms/batch "
              f"({b / times[name][1] * 1e3:.1f} frames/s)")
    return times


def time_batch_stages(device, cfg, reps: int = 5) -> None:
    """Host clock around one 16-frame 1080p batch of FrameMarker/FrameExtractor's
    work, split at its synchronising boundaries: upload (pinned staging +
    H2D), device compute, download.  Median of ``reps`` after a warm-up."""
    from vfp_tpu_torch.pipeline.embedder import upload_batch
    from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd

    rng = np.random.RandomState(5)
    b, h, w = cfg["b"], cfg["h"], cfg["w"]
    frames = natural_frames(rng, b, h, w)
    codec = DwtDctSvd()
    wm = spread_wm(codec, h, w, device)
    deg = DeShuffler(key=0, threshold="fixed").set_shape((len(PAYLOAD),))
    stages = {"mark": (lambda x: codec.mark_frames(x, wm)),
              "extract": (lambda x: deg.degenerate_batch(codec.extract_frames(x)))}
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

    errs = check_kernels(device, cfg)
    workroot = ROOT / "build" / "chip_smoke"
    workroot.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workroot) as tmp:
        counts = run_main_path(device, cfg, Path(tmp))
    times = time_kernels(device, cfg)
    time_batch_stages(device, cfg)
    print(f"timings above on {card}")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"vfp_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, replaces) in REPLACES.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
