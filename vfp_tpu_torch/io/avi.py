"""Chunk-level MJPEG-AVI access: demux without decode (copied from
``vfp_tpu/io/avi.py``).

Every frame of an MJPEG AVI is an independent JPEG in a ``00dc``/``00db``
chunk, so a splice is a RIFF walk that copies compressed bytes into the
muxer (``io/writers.py`` ``MjpegAviWriter.write_encoded``) with no
re-encode: the stream copy of an ffmpeg ``-c copy`` concat.  Works on this
package's AVIs, the JAX package's and other MJPG files (including
interleaved ``LIST rec`` groups).
"""

from __future__ import annotations

import struct
from pathlib import Path


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise IOError("truncated AVI")
    return b


def avi_meta(path) -> dict:
    """Header metadata: {width, height, fps, frames, mjpeg: bool}.

    Walks hdrl only (avih + the first 'vids' strh/strf); raises IOError on
    anything that is not a RIFF AVI.
    """
    with open(path, "rb") as f:
        if _read_exact(f, 4) != b"RIFF":
            raise IOError(f"not a RIFF file: {path}")
        f.read(4)
        if _read_exact(f, 4) != b"AVI ":
            raise IOError(f"not an AVI: {path}")
        meta = {"width": 0, "height": 0, "fps": 0.0, "frames": 0, "mjpeg": False}
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if fourcc == b"LIST":
                kind = _read_exact(f, 4)
                if kind in (b"hdrl", b"strl"):
                    continue  # descend
                f.seek(size - 4 + (size & 1), 1)  # skip movi/odml + pad
            elif fourcc == b"avih":
                body = _read_exact(f, size + (size & 1))
                if len(body) < 56:
                    raise IOError(f"avih box too short in {path}")
                vals = struct.unpack("<14I", body[:56])
                meta["fps"] = 1_000_000 / vals[0] if vals[0] else 0.0
                meta["frames"] = vals[4]
                meta["width"], meta["height"] = vals[8], vals[9]
            elif fourcc == b"strh":
                body = _read_exact(f, size + (size & 1))
                if body[:4] == b"vids":
                    if len(body) < 28:
                        raise IOError(f"strh box too short in {path}")
                    meta["mjpeg"] = body[4:8] in (b"MJPG", b"mjpg")
                    scale, rate = struct.unpack("<II", body[20:28])
                    if scale:
                        meta["fps"] = rate / scale
            else:
                f.seek(size + (size & 1), 1)
        return meta


def iter_video_chunk_spans(path):
    """Yield (offset, size) of each compressed video frame in the movi list:
    the lazy counterpart of iter_video_chunks, for readers that fetch the
    sample bytes later."""
    with open(path, "rb") as f:
        if _read_exact(f, 4) != b"RIFF":
            raise IOError(f"not a RIFF file: {path}")
        f.read(4)
        if _read_exact(f, 4) != b"AVI ":
            raise IOError(f"not an AVI: {path}")
        stack = []
        in_movi = False
        while True:
            while stack and f.tell() >= stack[-1]:
                if len(stack) == 1:
                    in_movi = False
                stack.pop()
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if fourcc == b"LIST":
                kind = _read_exact(f, 4)
                end = f.tell() + size - 4 + (size & 1)
                if kind == b"movi":
                    in_movi = True
                    stack = [end]
                elif in_movi and kind == b"rec ":
                    stack.append(end)
                else:
                    f.seek(size - 4 + (size & 1), 1)
            elif in_movi and fourcc[2:] in (b"dc", b"db"):
                yield f.tell(), size
                f.seek(size + (size & 1), 1)
            else:
                f.seek(size + (size & 1), 1)


def iter_video_chunks(path):
    """Yield each compressed video frame (bytes) from an AVI's movi list.

    Handles flat movi lists and interleaved ``LIST rec`` groups; ignores
    audio (``##wb``) and index chunks.
    """
    with open(path, "rb") as f:
        if _read_exact(f, 4) != b"RIFF":
            raise IOError(f"not a RIFF file: {path}")
        f.read(4)
        if _read_exact(f, 4) != b"AVI ":
            raise IOError(f"not an AVI: {path}")
        stack = []  # end offsets of LIST scopes we are inside
        in_movi = False
        while True:
            while stack and f.tell() >= stack[-1]:
                if len(stack) == 1:
                    in_movi = False
                stack.pop()
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if fourcc == b"LIST":
                kind = _read_exact(f, 4)
                end = f.tell() + size - 4 + (size & 1)
                if kind == b"movi":
                    in_movi = True
                    stack = [end]
                elif in_movi and kind == b"rec ":
                    stack.append(end)
                else:
                    f.seek(size - 4 + (size & 1), 1)
            elif in_movi and fourcc[2:] in (b"dc", b"db"):
                yield _read_exact(f, size)
                if size & 1:
                    f.read(1)
            else:
                f.seek(size + (size & 1), 1)


def splice_mjpeg_avis(segment_files, output_file) -> bool:
    """Stream-copy concat: all-MJPEG same-geometry AVIs -> one AVI, no
    re-encode.  Returns False (caller should fall back to the lossy
    frame-level splice) when any input is not a same-geometry MJPEG AVI."""
    from .writers import MjpegAviWriter

    try:
        metas = [avi_meta(p) for p in segment_files]
    except (IOError, struct.error):
        return False
    if not metas or not all(m["mjpeg"] for m in metas):
        return False
    w, h = metas[0]["width"], metas[0]["height"]
    if any((m["width"], m["height"]) != (w, h) for m in metas):
        return False
    out = MjpegAviWriter(output_file, w, h, fps=metas[0]["fps"] or 30.0)
    try:
        for p in segment_files:
            for chunk in iter_video_chunks(p):
                out.write_encoded(chunk)
    except (IOError, struct.error):
        # truncated movi data mid-splice (avi_meta skips movi wholesale, so
        # it cannot pre-validate it): remove the partial output and let the
        # caller fall back to the frame-level splice
        out.close()
        Path(output_file).unlink(missing_ok=True)
        return False
    finally:
        out.close()
    if out._nframes == 0:
        Path(output_file).unlink(missing_ok=True)
        return False
    return True
