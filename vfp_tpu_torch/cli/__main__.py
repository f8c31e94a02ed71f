"""CLI of the PyTorch/CUDA port: mark and detect with the ported codecs, and
the HLS fingerprinting workflow.

    python -m vfp_tpu_torch.cli mark INPUT OUTPUT [--codec dwtDctSvd|dct|dtcwtKey|dtcwtImg]
                                [--payload 01100101 | --wm-image GRAY.png]
                                [--generator auto|shuffler|grayscale] [--key 0] [--device cuda]
                                [--profile DIR]
    python -m vfp_tpu_torch.cli detect INPUT [--codec dwtDctSvd|dct|dtcwtKey|dtcwtImg]
                                [--payload-len 8 | --payload BITS] [--key 0]
                                [--out-dir DIR --wm-height 64 --wm-width 64]
    python -m vfp_tpu_torch.cli test-frame IMAGE OUT_DIR [--codec ...] [--payload BITS]
    python -m vfp_tpu_torch.cli hls-mark INPUT OUTDIR --copies 3 [--segment-duration 2]
                                [--workers N | --distributed [--coordinator HOST:PORT
                                 --num-processes N --process-id I]]
    python -m vfp_tpu_torch.cli leak COPIES_JSON [--pattern 012] [--random-seed N]
    python -m vfp_tpu_torch.cli trace LEAKED OUTDIR [--payload-file F] [--max-copies 3]
    python -m vfp_tpu_torch.cli durability INPUT OUTDIR [--codec dwtDctSvd|dct|dtcwtKey]
                                [--segment-duration 2] [--quality 90] [--key 0] [--alpha A]
    python -m vfp_tpu_torch.cli serve [--host 0.0.0.0] [--port 8000] [--data-dir serve_data]

The same subcommands, flags and printed lines as ``python -m vfp_tpu.cli``
for the DWT+DCT+SVD codec, the perceptual DCT-QIM codec (``--codec dct``),
the DT-CWT key codec (``--codec dtcwtKey``: a keyed spread-spectrum
plane, the payload ignored; detect prints per-file presence) and the DT-CWT
image codec (``--codec dtcwtImg``: a block-scrambled image payload from
``--wm-image``; detect writes the recovered image of every frame to
``--out-dir`` as ``wm_NNNN.png``), plus ``--device``.  ``--wm-image`` is
read as the JAX CLI's ``cv2.imread(..., IMREAD_GRAYSCALE)`` reads it
(``io/images.py:read_image_gray``: PNG of any 8-bit colour type, or a
baseline JPEG's Y).  On ``--device cuda`` every codec marks and detects through
its CUDA kernels.  The device defaults to ``cuda`` and is never changed
silently: ``--device cuda`` without a GPU raises; pass ``--device cpu`` to
run on the CPU.  ``--fast-dots`` is accepted and ignored: the port
computes in float32.  Containers follow the host, as in the JAX CLI.  With
an ``ffmpeg`` binary on PATH (the JAX package's route, ``io/ffmpeg.py``):
input is ``.rawv``, ``.y4m`` or anything ffmpeg decodes (H.264 ``.mp4``
among them, through an rgb24 pipe), output is ``.rawv``, ``.avi``, ``.y4m``
or anything else through ffmpeg (``mark ... out.mp4``: H.264); ``hls-mark``
segments with ffmpeg into ``.mp4``, marks ``.mp4`` variants and remuxes
them to ``.m4s``, and ``leak`` splices an ``.mp4`` with ffmpeg's concat.
Without one: input is ``.rawv`` (exact), MJPEG ``.avi``, MJPEG-in-MP4
``.mp4``/``.m4s`` or ``.y4m``; output is ``.rawv``, ``.avi`` or ``.y4m`` (an
``.mp4`` whose video is not JPEG raises: the port has no mp4v/H.264 codec of
its own); ``hls-mark`` segments a ``.rawv`` into ``.rawv`` and anything else
into MJPEG ``.avi`` (the JAX CLI's choice without ffmpeg), with the source's
audio in per-segment sidecars that ``leak`` muxes back into an ``.mp4``.
``durability`` runs the JAX CLI's lossy
experiment, through ffmpeg's ``.mp4`` segments, pipe writer and concat where
the binary is on PATH, else through MJPEG ``.avi`` (JPEGs coded as cv2 codes
them), prints its JSON report and exits 0 when it passes, 1 when not;
without ffmpeg ``--container mp4`` is refused (no mp4v encoder or decoder).  ``hls-mark`` also prints ``mark_segments``'
stage seconds; its ``--workers`` processes mark on ``--device`` (the card
by default, where the JAX CLI's workers run on the CPU), and its
``--distributed`` ranks join a torch.distributed gloo group.  ``mark
--profile`` writes a torch.profiler Chrome trace (the JAX CLI: an xprof
directory) that holds the program's spans (``utils/profiling.py``) beside
the kernels, and prints one line per span name: its count, total ms and
self ms (less the time its child spans cover).  ``test-frame`` writes its
JPEGs as cv2.imwrite does, through the port's JPEG encoder.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device


READ_HELP = ("video to read: .rawv, .y4m, or, with an ffmpeg binary on PATH, anything it "
             "decodes (H.264 .mp4 among them); without one, MJPEG .avi/.mp4/.m4s")
WRITE_HELP = ("video to write: .rawv, .avi (MJPEG at --quality), .y4m, or, with an ffmpeg "
              "binary on PATH, any other suffix through ffmpeg (.mp4: H.264)")


def _payload_bits(s: str) -> np.ndarray:
    return np.array([int(c) for c in s])


def _generator(codec_name: str, key: int, generator: str = "auto"):
    """The payload spreader paired with a codec, as vfp_tpu.cli pairs them:
    CorrShuffler with dtcwtKey, BlockShuffler with dtcwtImg, GrayScale on
    request, else Shuffler."""
    from ..wm import BlockShuffler, CorrShuffler, GrayScale, Shuffler

    if _is_dtcwt_key(codec_name):
        return CorrShuffler(key=key)
    if _is_dtcwt_img(codec_name):
        return BlockShuffler(key=key)
    return GrayScale(key=key) if generator == "grayscale" else Shuffler(key=key)


def cmd_mark(args):
    from ..io import open_reader, open_writer, read_image_gray
    from ..pipeline import Embedder, FrameMarker
    from ..utils import make_codec

    device = resolve_device(args.device)
    codec = make_codec(args.codec)
    if args.wm_image:
        payload = read_image_gray(args.wm_image).astype(np.float32)
    else:
        payload = _payload_bits(args.payload)
    reader = open_reader(args.input)
    generator = _generator(args.codec, args.key, args.generator)
    wm = generator.generate_wm(payload, codec.wm_capacity((reader.height, reader.width, 3)))
    writer = open_writer(args.output, reader.width, reader.height, reader.fps, args.quality)

    def run():
        return Embedder(reader, FrameMarker(codec, wm, args.batch_size, device=device),
                        writer).start()

    if args.profile:
        from ..utils import profile_trace
        from ..utils.profiling import record_spans, span_lines

        with profile_trace(args.profile, device), record_spans() as spans:
            stats = run()
        print(f"profiler trace -> {args.profile}")
        for line in span_lines(spans):
            print(line)
    else:
        stats = run()
    print(f"marked {stats.frames} frames in {stats.seconds:.2f}s ({stats.fps:.1f} fps)")
    if stats.stage_seconds:
        print(f"stages: {stats.stage_seconds}")


def _is_dtcwt_key(name: str) -> bool:
    return name.lower() in ("dtcwtkey", "dtcwt_key")


def _is_dtcwt_img(name: str) -> bool:
    return name.lower() in ("dtcwtimg", "dtcwt_img")


@torch.inference_mode()
def _detect_images(args, codec, device):
    """One recovered watermark image per frame, unscrambled by
    DeBlockShuffler and written to --out-dir as wm_NNNN.png, as vfp_tpu.cli."""
    from ..io import open_reader, write_png_gray
    from ..pipeline.transfer import upload_batch
    from ..wm import DeBlockShuffler

    out_dir = Path(args.out_dir or "detected_wms")
    out_dir.mkdir(parents=True, exist_ok=True)
    deg = DeBlockShuffler(key=args.key).set_shape((args.wm_height, args.wm_width))
    reader = open_reader(args.input)
    i = 0
    try:
        while True:
            b = reader.read_batch(args.batch_size)
            if b is None:
                break
            planes = codec.extract_frames(upload_batch(b, len(b), device)).cpu().numpy()
            for p in planes:
                rec = deg.degenerate(p)
                write_png_gray(out_dir / f"wm_{i:04d}.png", np.clip(rec, 0, 255).astype(np.uint8))
                i += 1
    finally:
        reader.close()
    print(f"recovered {i} watermark images -> {out_dir}/")


@torch.inference_mode()
def _detect_presence(args, codec, device):
    """Per-frame normalised correlations with the keyed plane, as vfp_tpu.cli."""
    from ..io import open_reader
    from ..pipeline.transfer import upload_batch
    from ..wm import DeCorrShuffler

    deg = DeCorrShuffler(key=args.key)
    reader = open_reader(args.input)
    corrs = []
    try:
        while True:
            b = reader.read_batch(args.batch_size)
            if b is None:
                break
            planes = codec.extract_frames(upload_batch(b, len(b), device))
            corrs.extend(deg.correlation_batch(planes).cpu().tolist())
    finally:
        reader.close()
    present = sum(c > deg.threshold for c in corrs)
    print(f"frames: {len(corrs)}")
    print(f"watermark present in {present}/{len(corrs)} frames "
          f"(mean correlation {np.mean(corrs):.3f})")


def cmd_detect(args):
    from ..io import open_reader
    from ..pipeline import Extractor, FrameExtractor
    from ..utils import make_codec
    from ..wm import DeShuffler

    device = resolve_device(args.device)
    codec = make_codec(args.codec)
    if _is_dtcwt_key(args.codec):
        return _detect_presence(args, codec, device)
    if _is_dtcwt_img(args.codec):
        return _detect_images(args, codec, device)
    expected = None
    if args.payload:
        expected = _payload_bits(args.payload)
        args.payload_len = len(expected)
    deg = DeShuffler(key=args.key, threshold=args.threshold).set_shape((args.payload_len,))
    res = Extractor(open_reader(args.input),
                    FrameExtractor(codec, deg, args.batch_size, device=device)).start()
    pattern, freq = res.majority()
    for i, p in enumerate(res.payloads):
        logging.getLogger("vfp_tpu_torch.cli").info("frame %d: %s", i, p.tolist())
    print(f"frames: {res.frames} ({res.fps:.1f} fps)")
    print(f"majority payload: {''.join(map(str, pattern))} (frequency {freq:.2f})")
    if expected is not None:
        ok = bool(np.array_equal(pattern, expected))
        print(f"matches expected payload: {ok}")
        if not ok:
            raise SystemExit(1)


def _degenerator(codec_name: str, key: int, generator: str = "auto"):
    """The inverse of ``_generator``'s spreader, with the fixed threshold for
    the bit payloads, as vfp_tpu.cli pairs them."""
    from ..wm import DeBlockShuffler, DeCorrShuffler, DeGrayScale, DeShuffler

    if _is_dtcwt_key(codec_name):
        return DeCorrShuffler(key=key)
    if _is_dtcwt_img(codec_name):
        return DeBlockShuffler(key=key)
    return DeGrayScale(key=key) if generator == "grayscale" else DeShuffler(key=key,
                                                                              threshold="fixed")


@torch.inference_mode()
def cmd_test_frame(args):
    """One-image roundtrip, as vfp_tpu.cli's: mark the image, write the marked
    image (``output.jpeg`` at --quality) and its amplified difference
    (``diff.jpeg``), read the JPEG back, extract and report.  The JPEGs are
    the bytes cv2.imwrite writes, through the port's encoder."""
    from ..io import read_image_bgr, read_image_gray
    from ..native.jpeg import decode_jpeg, encode_jpeg, encode_jpeg_gray
    from ..utils import make_codec
    from ..wm import DeCorrShuffler

    device = resolve_device(args.device)
    codec = make_codec(args.codec)
    generator = _generator(args.codec, args.key, args.generator)
    deg = _degenerator(args.codec, args.key, args.generator)
    frame = read_image_bgr(args.image)
    if args.wm_image:
        payload = read_image_gray(args.wm_image).astype(np.float32)
    else:
        payload = _payload_bits(args.payload)
    wm = generator.generate_wm(payload, codec.wm_capacity(frame.shape))
    wm = torch.as_tensor(np.asarray(wm, np.float32), device=device)
    marked = codec.mark_frames(torch.as_tensor(frame[None], device=device), wm)[0].cpu().numpy()
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # the codecs work on BGR as cv2 gives it; the JPEG coder takes file order
    (out_dir / "output.jpeg").write_bytes(encode_jpeg(marked[..., ::-1], args.quality))
    diff = np.clip((marked.astype(np.int32) - frame.astype(np.int32)) * 10 + 128, 0,
                   255).astype(np.uint8)
    (out_dir / "diff.jpeg").write_bytes(encode_jpeg(diff[..., ::-1]))
    mse = np.mean((marked.astype(float) - frame.astype(float)) ** 2)
    psnr = 10 * np.log10(255**2 / max(mse, 1e-12))
    print(f"marked image -> {out_dir/'output.jpeg'} (PSNR {psnr:.1f} dB)")

    readback = decode_jpeg((out_dir / "output.jpeg").read_bytes())[..., ::-1]
    readback = torch.as_tensor(np.ascontiguousarray(readback)[None], device=device)
    plane = codec.extract_frames(readback)[0].cpu().numpy()
    if isinstance(deg, DeCorrShuffler):
        print(f"watermark present: {deg.degenerate(plane)}")
    elif args.wm_image:
        deg.set_shape(payload.shape)
        rec = np.asarray(deg.degenerate(plane), np.float32)
        # cv2.imwrite of a float32 image: saturate_cast to u8 (cvRound: half to
        # even), then a grayscale JPEG at cv2's default quality
        u8 = np.clip(np.rint(rec), 0, 255).astype(np.uint8)
        (out_dir / "degenerate.jpeg").write_bytes(encode_jpeg_gray(u8))
        print(f"recovered watermark image -> {out_dir/'degenerate.jpeg'}")
    else:
        deg.set_shape(payload.shape)
        rec = deg.degenerate(plane.flatten())
        print(f"recovered payload: {''.join(map(str, rec))} "
              f"(expected {''.join(map(str, payload))})")


def cmd_hls_mark(args):
    from ..fingerprint import mark_segments, segment_video, write_hls_playlists
    from ..fingerprint.marker import verify_segments, write_manifests

    device = resolve_device(args.device)
    base = Path(args.output_dir)
    if args.clean and base.exists():
        shutil.rmtree(base)
    segments = segment_video(args.input, base / "segments", args.segment_duration)
    print(f"created {len(segments)} segments")
    stats = {}
    common = dict(copies=args.copies, key=args.key, batch_size=args.batch_size,
                  quality=args.quality, stats=stats)
    if args.distributed:
        # one process per host (or per card) against a shared output dir: the
        # ranks split the segments and rank 0 merges the manifest shards
        from ..parallel.farm import mark_segments_distributed

        marked, payloads, copies = mark_segments_distributed(
            segments, base / "marked_segments", coordinator_address=args.coordinator,
            num_processes=args.num_processes, process_id=args.process_id, device=device,
            **common)
    elif args.workers > 1:
        from ..parallel.farm import mark_segments_parallel

        marked, payloads, copies = mark_segments_parallel(
            segments, base / "marked_segments", workers=args.workers, worker_device=device,
            **common)
    else:
        marked, payloads, copies = mark_segments(
            segments, base / "marked_segments", resume=args.resume, device=device, **common)
    print(f"mark_segments stats: {stats}")
    if args.distributed and stats["rank"] != 0:
        print(f"rank {stats['rank']}: shard done ({len(marked)} marked segments); "
              "rank 0 owns the merge")
        return
    failed = []
    for m, (pattern, freq, ok) in zip(
            marked, verify_segments(marked, key=args.key, batch_size=args.batch_size,
                                    device=device)):
        if not ok or freq < 0.5:
            failed.append(
                {
                    "segment": Path(m.file).name,
                    "segment_number": m.segment_number,
                    "copy_index": m.copy_index,
                    "expected_pattern": m.payload,
                    "detected_pattern": pattern.tolist() if pattern is not None else None,
                    "frequency": freq,
                }
            )
    master, playlist, seg_map, variants = write_hls_playlists(
        marked, base / "hls", copies=args.copies, segment_duration=args.segment_duration
    )
    write_manifests(base, payloads, copies, seg_map, failed)
    print("\n===== WATERMARK VERIFICATION RESULTS =====")
    if failed:
        print(f"Failed to properly watermark {len(failed)} segments:")
        for f in failed:
            print(f"  Segment {f['segment_number']} copy {f['copy_index']} ({f['segment']})")
    else:
        print("All segments were watermarked successfully!")
    print(f"master playlist: {master}")


def cmd_leak(args):
    from ..fingerprint import generate_leak

    resolve_device(args.device)
    leaked, info = generate_leak(
        args.copies_file, args.output_file, args.pattern, args.random_seed,
        create_hls=args.create_hls, segment_duration=args.segment_duration,
    )
    print(f"leaked video: {leaked}")
    print(f"pattern: {info['pattern_string']}")
    if "custom_hls_playlist" in info:
        print(f"custom HLS playlist: {info['custom_hls_playlist']}")
    if args.detect:
        base = Path(args.copies_file).parent
        ns = argparse.Namespace(
            input=str(leaked), output_dir=str(base / "detection"),
            payload_file=str(base / "segment_payloads.json"),
            copies_file=None, clean=False,
            segment_duration=args.segment_duration, max_copies=10, key=0,
            device=args.device,
        )
        cmd_trace(ns)
    if args.serve:
        # after --create-hls, serve the playback bundle over HTTP with CORS
        # headers (reference: tests/generate_leak.py:577-611)
        if "custom_hls_playlist" not in info:
            print("--serve requires --create-hls (no HLS bundle was created)")
            return
        import functools
        from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

        hls_dir = Path(args.copies_file).parent / "hls"

        class _CorsHandler(SimpleHTTPRequestHandler):
            def end_headers(self):
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods", "GET, OPTIONS")
                self.send_header("Access-Control-Allow-Headers", "Content-Type")
                self.send_header("Cache-Control",
                                 "no-store, no-cache, must-revalidate")
                super().end_headers()

            def do_OPTIONS(self):
                self.send_response(200)
                self.end_headers()

        handler = functools.partial(_CorsHandler, directory=str(hls_dir))
        with ThreadingHTTPServer(("", args.serve_port), handler) as httpd:
            print(f"Serving HLS playback from {hls_dir} on port {args.serve_port}")
            print(f"Open http://localhost:{args.serve_port}/index.html  (Ctrl+C stops)")
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                print("\nServer stopped by user.")


def cmd_trace(args):
    from ..fingerprint import trace_leak

    device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    copies_file = getattr(args, "copies_file", None)
    # reference quirk preserved: a relative 'detection[/...]' output dir is
    # relocated next to the copies file when one is given
    # (reference: tests/detect_watermarks.py:286-292)
    if copies_file and (args.output_dir == "detection"
                        or args.output_dir.startswith("detection/")):
        out_dir = Path(copies_file).resolve().parent / args.output_dir
    if getattr(args, "clean", False) and out_dir.exists():
        shutil.rmtree(out_dir)
    result = trace_leak(
        args.input, out_dir, args.payload_file,
        segment_duration=args.segment_duration, max_copies=args.max_copies, key=args.key,
        device=device,
    )
    print("\n===== WATERMARK DETECTION RESULTS =====")
    for s in result.segments:
        print(f"Segment {s.segment_number}: copy={s.detected_copy_index} freq={s.match_frequency:.2f}")
    print("\n===== DETECTION SUMMARY =====")
    print(f"Total segments: {len(result.segments)}")
    print(f"Success rate: {result.success_rate * 100:.2f}%")
    print("\n===== FINGERPRINT SEQUENCE =====")
    print(f"Copy sequence: {result.copy_sequence}")
    if result.fingerprint is not None:
        print(f"Copy fingerprint: {result.fingerprint}")


def cmd_durability(args):
    from ..workflows.durability import run_durability, run_durability_corr

    device = resolve_device(args.device)
    name, container, alpha = args.codec, args.container, args.alpha
    if name == "dtcwtKey":
        report = run_durability_corr(
            args.input, args.output_dir, segment_duration=args.segment_duration,
            quality=args.quality, key=args.key, container=container, device=device,
        )
    else:
        if name == "dct":
            from ..wm import DctQim

            codec = DctQim(alpha=alpha) if alpha is not None else DctQim()
        else:
            from ..wm import DwtDctSvd

            codec = (DwtDctSvd(scales=(0.0, alpha, 0.0))
                     if alpha is not None else DwtDctSvd())
        report = run_durability(
            args.input, args.output_dir, segment_duration=args.segment_duration,
            quality=args.quality, key=args.key, codec=codec, container=container,
            device=device,
        )
    print(json.dumps(report, indent=2))
    sys.exit(0 if report["is_successful"] else 1)


def cmd_serve(args):
    from ..serve.app import run_server

    run_server(host=args.host, port=args.port, data_dir=args.data_dir, device=args.device)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s  %(message)s"
    )
    p = argparse.ArgumentParser(prog="vfp_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--verbose", "-v", action="store_true",
                   help="enable DEBUG logging (incl. @trace decorators)")
    sub = p.add_subparsers(dest="cmd", required=True)

    codecs = ["dwtDctSvd", "dct", "dtcwtKey", "dtcwtImg"]
    fast_dots_help = "accepted for vfp_tpu.cli's sake and ignored: the port computes in float32"

    m = sub.add_parser("mark", help="embed a payload into every frame")
    m.add_argument("input", help=READ_HELP)
    m.add_argument("output", help=WRITE_HELP)
    m.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    m.add_argument("--fast-dots", action="store_true", help=fast_dots_help)
    m.add_argument("--payload", default="01100101")
    m.add_argument("--wm-image", default=None,
                   help="watermark image payload, read as grayscale (PNG or baseline JPEG)")
    m.add_argument("--generator", choices=["auto", "shuffler", "grayscale"], default="auto")
    m.add_argument("--key", type=int, default=0)
    m.add_argument("--batch-size", type=int, default=16)
    m.add_argument("--quality", type=int, default=95)
    m.add_argument("--device", default="cuda", help="torch device (default cuda)")
    m.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run into DIR (Chrome trace JSON) "
                        "and print the program's spans: count, total ms, self ms")
    m.set_defaults(fn=cmd_mark)

    d = sub.add_parser("detect", help="extract per-frame payloads")
    d.add_argument("input", help=READ_HELP)
    d.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    d.add_argument("--fast-dots", action="store_true", help=fast_dots_help)
    d.add_argument("--payload-len", type=int, default=8)
    d.add_argument("--payload", default=None,
                   help="expected payload bits; sets --payload-len and prints match")
    d.add_argument("--key", type=int, default=0)
    d.add_argument("--threshold", choices=["midpoint", "fixed"], default="fixed")
    d.add_argument("--batch-size", type=int, default=16)
    d.add_argument("--out-dir", default=None, help="output dir for recovered images (dtcwtImg)")
    d.add_argument("--wm-height", type=int, default=64)
    d.add_argument("--wm-width", type=int, default=64)
    d.add_argument("--device", default="cuda", help="torch device (default cuda)")
    d.set_defaults(fn=cmd_detect)


    tf = sub.add_parser("test-frame", help="single-image embed/extract roundtrip")
    tf.add_argument("image", help="a PNG (8-bit gray, gray + alpha, RGB, RGBA) or baseline JPEG")
    tf.add_argument("out_dir")
    tf.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    tf.add_argument("--fast-dots", action="store_true", help=fast_dots_help)
    tf.add_argument("--payload", default="01100101")
    tf.add_argument("--wm-image", default=None,
                    help="watermark image payload, read as grayscale (PNG or baseline JPEG)")
    tf.add_argument("--generator", choices=["auto", "shuffler", "grayscale"], default="auto")
    tf.add_argument("--key", type=int, default=0)
    tf.add_argument("--quality", type=int, default=95, help="output JPEG quality")
    tf.add_argument("--device", default="cuda", help="torch device (default cuda)")
    tf.set_defaults(fn=cmd_test_frame)

    h = sub.add_parser(
        "hls-mark", help="segment, mark N variants, build HLS",
        description="Segment INPUT (with ffmpeg on PATH: .mp4 segments, .mp4 variants and "
                    ".m4s HLS fragments, all by ffmpeg; without: .rawv segments for a "
                    ".rawv, MJPEG .avi with audio sidecars otherwise), mark each in "
                    "--copies variants on --device (in --workers processes, or one rank "
                    "of --distributed), verify them and write the HLS playlists and "
                    "manifests.")
    h.add_argument("input", help=READ_HELP)
    h.add_argument("output_dir")
    h.add_argument("--copies", type=int, default=1)
    h.add_argument("--segment-duration", type=float, default=2.0)
    h.add_argument("--clean", action="store_true")
    h.add_argument("--resume", action="store_true",
                   help="skip segment variants whose marked files already exist")
    h.add_argument("--key", type=int, default=0)
    h.add_argument("--batch-size", type=int, default=16)
    h.add_argument("--quality", type=int, default=95)
    h.add_argument("--device", default="cuda",
                   help="torch device of the marking processes and the verify (default cuda)")
    h.add_argument("--workers", type=int, default=1,
                   help="single-host process farm: fan segments over N worker "
                        "processes on --device (parallel/farm.py)")
    h.add_argument("--distributed", action="store_true",
                   help="multi-host farm via torch.distributed rank sharding (gloo); "
                        "run the same command in every process against a shared "
                        "output dir")
    h.add_argument("--coordinator", default=None,
                   help="rank 0's host:port for --distributed; omit for torchrun's "
                        "env:// variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
    h.add_argument("--num-processes", dest="num_processes", type=int, default=None)
    h.add_argument("--process-id", dest="process_id", type=int, default=None)
    h.set_defaults(fn=cmd_hls_mark)

    l = sub.add_parser("leak", help="splice a leaked copy from variants")
    l.add_argument("copies_file")
    l.add_argument("--output-file", default=None,
                   help="default: leaked_video.mp4 beside COPIES_FILE (ffmpeg's concat) "
                        "with ffmpeg on PATH; without it .mp4 when every variant has an "
                        "audio sidecar, else the variants' own suffix")
    l.add_argument("--pattern", default=None)
    l.add_argument("--random-seed", type=int, default=None)
    l.add_argument("--segment-duration", type=float, default=2.0)
    l.add_argument("--serve", action="store_true",
                   help="after --create-hls, serve the playback bundle over "
                        "HTTP with CORS headers until interrupted")
    l.add_argument("--serve-port", type=int, default=8000)
    l.add_argument("--create-hls", action="store_true",
                   help="emit a per-pattern HLS playlist + CORS server + player page")
    l.add_argument("--detect", action="store_true")
    l.add_argument("--device", default="cuda",
                   help="torch device of --detect's trace (default cuda)")
    l.set_defaults(fn=cmd_leak)

    t = sub.add_parser("trace", help="recover the fingerprint from a leak")
    t.add_argument("input", help=READ_HELP)
    t.add_argument("output_dir")
    t.add_argument("--payload-file", default=None)
    t.add_argument("--copies-file", default=None,
                   help="segment_copies.json; relocates a relative "
                        "'detection' output dir next to it (reference quirk)")
    t.add_argument("--clean", action="store_true",
                   help="remove the output dir before tracing")
    t.add_argument("--segment-duration", type=float, default=2.0)
    t.add_argument("--max-copies", type=int, default=3)
    t.add_argument("--key", type=int, default=0)
    t.add_argument("--device", default="cuda", help="torch device (default cuda)")
    t.set_defaults(fn=cmd_trace)

    u = sub.add_parser("durability", help="mark -> re-encode -> re-detect experiment")
    u.add_argument("input"), u.add_argument("output_dir")
    u.add_argument("--segment-duration", type=float, default=2.0)
    u.add_argument("--quality", type=int, default=90)
    u.add_argument("--key", type=int, default=0)
    u.add_argument("--codec", choices=["dwtDctSvd", "dct", "dtcwtKey"], default="dwtDctSvd",
                   help="dtcwtKey runs the correlation-identification variant")
    u.add_argument("--container", choices=["avi", "mp4"], default=None,
                   help="lossy channel: avi = MJPEG at --quality (intra-only); mp4 = the "
                        "ffmpeg pipe writer, only where ffmpeg is on PATH (without it the "
                        "JAX CLI's mp4 is cv2 mp4v, which the port has no encoder of)")
    u.add_argument("--alpha", type=float, default=None,
                   help="embedding strength override (QIM scale for dwtDctSvd/dct)")
    u.add_argument("--device", default="cuda", help="torch device (default cuda)")
    u.set_defaults(fn=cmd_durability)

    s = sub.add_parser("serve", help="run the fingerprinting HTTP service")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--data-dir", default="serve_data")
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")
    s.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    if args.verbose:
        logging.getLogger().setLevel(logging.DEBUG)
    args.fn(args)


if __name__ == "__main__":
    main()
