"""CLI of the PyTorch/CUDA port: mark and detect with the ported codecs.

    python -m vfp_tpu_torch.cli mark INPUT OUTPUT [--codec dwtDctSvd|dct|dtcwtKey]
                                [--payload 01100101] [--key 0] [--device cuda]
    python -m vfp_tpu_torch.cli detect INPUT [--codec dwtDctSvd|dct|dtcwtKey]
                                [--payload-len 8 | --payload BITS] [--key 0]

The same subcommands, flags and printed lines as ``python -m vfp_tpu.cli``
for the DWT+DCT+SVD codec, the perceptual DCT-QIM codec (``--codec dct``)
and the DT-CWT key codec (``--codec dtcwtKey``: a keyed spread-spectrum
plane, the payload ignored; detect prints per-file presence), plus
``--device``.  On ``--device cuda`` every codec marks and detects through
its CUDA kernels.  The device defaults to ``cuda`` and is never changed
silently: ``--device cuda`` without a GPU raises; pass ``--device cpu`` to
run on the CPU.  ``--fast-dots`` is accepted and ignored: the port
computes in float32.  Input and output are ``.rawv`` files.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch


def _payload_bits(s: str) -> np.ndarray:
    return np.array([int(c) for c in s])


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA GPU and none is available; "
                           "pass --device cpu to run on the CPU")
    if device.type == "cuda":
        # QIM bins need full float32 products on the codecs' tensor paths
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def cmd_mark(args):
    from ..io import open_reader, open_writer
    from ..pipeline import Embedder, FrameMarker
    from ..utils import make_codec
    from ..wm import CorrShuffler, Shuffler

    device = _device(args.device)
    codec = make_codec(args.codec)
    reader = open_reader(args.input)
    generator = CorrShuffler(key=args.key) if _is_dtcwt_key(args.codec) else Shuffler(key=args.key)
    wm = generator.generate_wm(
        _payload_bits(args.payload), codec.wm_capacity((reader.height, reader.width, 3)))
    writer = open_writer(args.output, reader.width, reader.height, reader.fps, args.quality)
    stats = Embedder(reader, FrameMarker(codec, wm, args.batch_size, device=device), writer).start()
    print(f"marked {stats.frames} frames in {stats.seconds:.2f}s ({stats.fps:.1f} fps)")
    if stats.stage_seconds:
        print(f"stages: {stats.stage_seconds}")


def _is_dtcwt_key(name: str) -> bool:
    return name.lower() in ("dtcwtkey", "dtcwt_key")


@torch.inference_mode()
def _detect_presence(args, codec, device):
    """Per-frame normalised correlations with the keyed plane, as vfp_tpu.cli."""
    from ..io import open_reader
    from ..pipeline.embedder import upload_batch
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

    device = _device(args.device)
    codec = make_codec(args.codec)
    if _is_dtcwt_key(args.codec):
        return _detect_presence(args, codec, device)
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


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s  %(message)s"
    )
    p = argparse.ArgumentParser(prog="vfp_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--verbose", "-v", action="store_true", help="enable DEBUG logging")
    sub = p.add_subparsers(dest="cmd", required=True)

    codecs = ["dwtDctSvd", "dct", "dtcwtKey"]
    fast_dots_help = "accepted for vfp_tpu.cli's sake and ignored: the port computes in float32"

    m = sub.add_parser("mark", help="embed a payload into every frame")
    m.add_argument("input"), m.add_argument("output")
    m.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    m.add_argument("--fast-dots", action="store_true", help=fast_dots_help)
    m.add_argument("--payload", default="01100101")
    m.add_argument("--key", type=int, default=0)
    m.add_argument("--batch-size", type=int, default=16)
    m.add_argument("--quality", type=int, default=95)
    m.add_argument("--device", default="cuda", help="torch device (default cuda)")
    m.set_defaults(fn=cmd_mark)

    d = sub.add_parser("detect", help="extract per-frame payloads")
    d.add_argument("input")
    d.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    d.add_argument("--fast-dots", action="store_true", help=fast_dots_help)
    d.add_argument("--payload-len", type=int, default=8)
    d.add_argument("--payload", default=None,
                   help="expected payload bits; sets --payload-len and prints match")
    d.add_argument("--key", type=int, default=0)
    d.add_argument("--threshold", choices=["midpoint", "fixed"], default="fixed")
    d.add_argument("--batch-size", type=int, default=16)
    d.add_argument("--device", default="cuda", help="torch device (default cuda)")
    d.set_defaults(fn=cmd_detect)

    args = p.parse_args(argv)
    if args.verbose:
        logging.getLogger().setLevel(logging.DEBUG)
    args.fn(args)


if __name__ == "__main__":
    main()
