"""CLI of the PyTorch/CUDA port: the flagship mark and detect.

    python -m vfp_tpu_torch.cli mark INPUT OUTPUT [--payload 01100101] [--key 0] [--device cuda]
    python -m vfp_tpu_torch.cli detect INPUT [--payload-len 8 | --payload BITS] [--key 0]

The same subcommands, flags and printed lines as ``python -m vfp_tpu.cli``
for the DWT+DCT+SVD codec, plus ``--device``.  The device defaults to
``cuda`` and is never changed silently: ``--device cuda`` without a GPU
raises; pass ``--device cpu`` to run on the CPU.  Use ``.rawv`` files: the
other containers need cv2, and ``.y4m`` is lossy 4:2:0.
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
    return device


def cmd_mark(args):
    from ..io import open_reader, open_writer
    from ..pipeline import Embedder, FrameMarker
    from ..utils import make_codec
    from ..wm import Shuffler

    device = _device(args.device)
    codec = make_codec(args.codec)
    reader = open_reader(args.input)
    wm = Shuffler(key=args.key).generate_wm(
        _payload_bits(args.payload), codec.wm_capacity((reader.height, reader.width, 3)))
    writer = open_writer(args.output, reader.width, reader.height, reader.fps, args.quality)
    stats = Embedder(reader, FrameMarker(codec, wm, args.batch_size, device=device), writer).start()
    print(f"marked {stats.frames} frames in {stats.seconds:.2f}s ({stats.fps:.1f} fps)")
    if stats.stage_seconds:
        print(f"stages: {stats.stage_seconds}")


def cmd_detect(args):
    from ..io import open_reader
    from ..pipeline import Extractor, FrameExtractor
    from ..utils import make_codec
    from ..wm import DeShuffler

    device = _device(args.device)
    codec = make_codec(args.codec)
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

    codecs = ["dwtDctSvd"]

    m = sub.add_parser("mark", help="embed a payload into every frame")
    m.add_argument("input"), m.add_argument("output")
    m.add_argument("--codec", choices=codecs, default="dwtDctSvd")
    m.add_argument("--payload", default="01100101")
    m.add_argument("--key", type=int, default=0)
    m.add_argument("--batch-size", type=int, default=16)
    m.add_argument("--quality", type=int, default=95)
    m.add_argument("--device", default="cuda", help="torch device (default cuda)")
    m.set_defaults(fn=cmd_mark)

    d = sub.add_parser("detect", help="extract per-frame payloads")
    d.add_argument("input")
    d.add_argument("--codec", choices=codecs, default="dwtDctSvd")
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
