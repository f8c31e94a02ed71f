"""Durability experiment: mark -> splice -> re-encode -> re-segment -> detect
(port of ``vfp_tpu/workflows/durability.py``).

Mirrors the reference harness (reference: tests/segment_mark_detect_hls.py):
segment the input, watermark each segment with an 8-bit binary encoding of
its segment number (reference: :42-55), verify detection on the marked
segments, run the full splice + re-encode + re-segment cycle, detect again,
and compare; the pass bar is >= 75% segment-level preservation (reference:
:500).

The lossy channel is the JAX package's.  Where an ``ffmpeg`` binary is on
PATH (``io.ffmpeg.have_ffmpeg``): ffmpeg's segmenter (``.mp4`` segments),
marked segments in the segments' own extension (the ffmpeg pipe writer for
``.mp4``; ``container`` overrides it), ffmpeg's concat into ``full.mp4``
(``full.avi`` for ``.avi`` segments) and ffmpeg's re-segmentation of it.
Without one: MJPEG ``.avi`` segments at quality 95, marked segments at
``quality``, a chunk-copy splice into one ``full.avi`` and a frame-exact
re-segmentation at quality 95, every JPEG coded by the native library as cv2
codes it (``native/jpeg.py``); ``container="mp4"`` is then refused, since the
JAX package's no-ffmpeg mp4 channel is cv2's mp4v encoder, an inter-frame
MPEG-4 Part 2 codec the port has no counterpart of.  The marks and the
detection run on ``device`` (default ``"cuda"``, raising without a GPU).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..fingerprint.leak import concatenate_segments
from ..fingerprint.marker import _read_all, verify_segment
from ..fingerprint.segmenter import segment_video
from ..io import ffmpeg, open_writer
from ..pipeline import FrameMarker
from ..pipeline.transfer import upload_batch
from ..utils.device import resolve_device
from ..wm import DwtDctSvd, Shuffler

logger = logging.getLogger(__name__)


def payload_for_segment_8bit(segment_number: int) -> np.ndarray:
    """8-bit binary of segment# mod 256 (reference: segment_mark_detect_hls.py:42-55)."""
    return np.array([int(b) for b in format(segment_number % 256, "08b")])


def _check_container(container, use_ffmpeg: bool) -> None:
    if container == "mp4" and not use_ffmpeg:
        raise ValueError("--container mp4 needs an ffmpeg binary on PATH: vfp_tpu_torch "
                         "has no mp4v encoder and no mp4v decoder. Without ffmpeg the JAX "
                         "package's mp4 channel is cv2's mp4v encoder, an inter-frame MPEG-4 "
                         "Part 2 codec (motion search, P-frames, its own rate control) read "
                         "back through cv2's FFmpeg backend, and the port reads only MJPEG MP4 "
                         "video. The lossy channel is MJPEG .avi (--container avi)")
    if container not in (None, "avi", "mp4"):
        raise ValueError(f"unknown container {container!r}: avi or mp4")


def _segment(input_file, segments_dir, segment_duration, use_ffmpeg: bool):
    """ffmpeg's .mp4 segments where it is on PATH, else the MJPEG .avi route."""
    if use_ffmpeg:
        return segment_video(input_file, segments_dir, segment_duration, use_ffmpeg=True)
    return segment_video(input_file, segments_dir, segment_duration, use_ffmpeg=False,
                         container="avi")


def _splice_name(marked_files) -> str:
    return "full.mp4" if str(marked_files[0]).endswith(".mp4") else "full.avi"


def _detect_all(segment_files, key: int, codec=None, *, device="cuda"):
    results = []
    for i, seg in enumerate(segment_files):
        expected = payload_for_segment_8bit(i)
        pattern, freq, ok = verify_segment(seg, expected, codec=codec, key=key, device=device)
        results.append(
            {
                "segment": str(seg),
                "segment_number": i,
                "expected_payload": expected.tolist(),
                "pattern": pattern.tolist() if pattern is not None else None,
                "frequency": freq,
                "success": ok,
            }
        )
    return results


def _corr_batch_fn(codec, refs_shape, *, device="cuda"):
    """[B,H,W,3] frames + [K,h,w] refs, both on ``device`` -> [B, K]
    normalized correlations of each frame's recovered plane against every
    candidate keyed reference (the 'fast' rule of reference:
    src/offmark/degenerator/de_corr_shuffler.py:14-30, batched over keys).
    ``codec.extract_frames`` runs on the DT-CWT kernels on CUDA; the
    standardisation (population std, as ``jnp.std``) and the einsum run in
    float32 there (TF32 off), so only the [B, K] table crosses to the host."""
    device = resolve_device(device)

    @torch.inference_mode()
    def fn(frames, refs):
        planes = codec.extract_frames(frames)  # [B, h, w]
        n = planes.shape[-2] * planes.shape[-1]
        dims = (-2, -1)
        p = ((planes - planes.mean(dim=dims, keepdim=True))
             / planes.std(dim=dims, keepdim=True, correction=0))
        r = (refs - refs.mean(dim=dims, keepdim=True)) / refs.std(dim=dims, keepdim=True,
                                                                  correction=0)
        return torch.einsum("bhw,khw->bk", p, r) / n

    return fn


def _corr_detect_all(segment_files, codec, refs, batch_size, threshold, *, device="cuda"):
    """Presence + identification per segment: a segment succeeds when its
    expected key both clears the correlation threshold and wins the argmax
    across all candidate keys on a majority of frames.  A short last batch
    is padded by repeating its last frame, as the JAX function does to keep
    one compiled shape."""
    device = resolve_device(device)
    fn = _corr_batch_fn(codec, refs.shape, device=device)
    refs_t = torch.as_tensor(np.asarray(refs, np.float32), device=device)
    results = []
    for i, seg in enumerate(segment_files):
        frames, _ = _read_all(seg)
        rows = []
        for s in range(0, len(frames), batch_size):
            batch = frames[s : s + batch_size]
            k = len(batch)
            if k < batch_size:
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], batch_size - k, axis=0)]
                )
            x = upload_batch(batch, batch_size, device)
            rows.append(fn(x, refs_t)[:k].cpu().numpy())
        corr = np.concatenate(rows)  # [n_frames, K]
        hit = (corr[:, i] > threshold) & (corr.argmax(axis=1) == i)
        freq = float(hit.mean())
        ok = freq >= 0.5
        results.append(
            {
                "segment": str(seg),
                "segment_number": i,
                "expected_payload": [i],
                "pattern": [int(np.bincount(corr.argmax(axis=1)).argmax())],
                "mean_correlation": float(corr[:, i].mean()),
                "frequency": freq,
                "success": ok,
            }
        )
    return results


def _mark_all(segments, marked_dir, codec, wm_for, batch_size, quality, container, device):
    """Mark every segment with its own watermark into marked_<stem>.<ext>."""
    marked_files = []
    for i, seg in enumerate(segments):
        frames, fps = _read_all(seg)
        h, w = frames.shape[1:3]
        fm = FrameMarker(codec, wm_for(i, (h, w, 3)), batch_size=batch_size, device=device)
        ext = f".{container}" if container else Path(seg).suffix
        out = marked_dir / f"marked_{Path(seg).stem}{ext}"
        with open_writer(out, w, h, fps, quality) as writer:
            for s in range(0, len(frames), batch_size):
                writer.write_batch(fm.mark(frames[s : s + batch_size]))
        marked_files.append(out)
    return marked_files


def run_durability_corr(
    input_file,
    output_dir,
    segment_duration: float = 2.0,
    quality: int = 90,
    batch_size: int = 8,
    threshold: float = 0.1,
    codec=None,
    key: int = 0,
    container: str | None = None,
    *,
    device="cuda",
):
    """DT-CWT spread-spectrum durability: mark each segment with a keyed
    +-1 plane (key = ``key`` + segment number), splice + re-encode +
    re-segment, and re-identify each segment by correlation (reference
    detector threshold: src/offmark/degenerator/de_corr_shuffler.py:27
    corr > 0.1).  Report schema matches run_durability; pass bar >= 75%
    preservation."""
    from ..wm import CorrShuffler, DeCorrShuffler
    from ..wm.dtcwt_codecs import DtcwtKey

    use_ffmpeg = ffmpeg.have_ffmpeg()
    _check_container(container, use_ffmpeg)
    device = resolve_device(device)
    t0 = time.time()
    codec = codec or DtcwtKey()
    base = Path(output_dir)
    marked_dir = base / "marked_segments"
    marked_dir.mkdir(parents=True, exist_ok=True)

    segments = _segment(input_file, base / "segments", segment_duration, use_ffmpeg)
    logger.info("created %d segments (corr mode)", len(segments))

    caps = []

    def wm_for(i, frame_shape):
        caps.append(tuple(codec.wm_capacity(frame_shape)))
        return CorrShuffler(key=key + i).generate_wm(None, caps[-1])

    marked_files = _mark_all(segments, marked_dir, codec, wm_for, batch_size, quality,
                             container, device)
    refs = np.stack(
        [
            np.asarray(DeCorrShuffler(key=key + k)._reference(caps[-1]), np.float32)
            for k in range(len(segments))
        ]
    )
    original_results = _corr_detect_all(marked_files, codec, refs, batch_size, threshold,
                                        device=device)

    spliced = base / _splice_name(marked_files)
    concatenate_segments(marked_files, spliced)
    resegmented = _segment(spliced, base / "resegmented", segment_duration, use_ffmpeg)
    reencoded_results = _corr_detect_all(
        resegmented[: len(segments)], codec, refs, batch_size, threshold, device=device
    )
    return _analyze(original_results, reencoded_results, t0)


def run_durability(
    input_file,
    output_dir,
    segment_duration: float = 2.0,
    quality: int = 90,
    key: int = 0,
    batch_size: int = 16,
    codec=None,
    container: str | None = None,
    *,
    device="cuda",
):
    """Returns the analysis report dict (keys mirror the reference's
    analyze_results, segment_mark_detect_hls.py:320-386, plus wall_seconds).

    ``container`` picks the lossy channel the watermark must survive: None
    keeps the segments' own extension (``.mp4`` through ffmpeg where it is
    on PATH, else MJPEG ``.avi`` at ``quality``), "avi" MJPEG, "mp4" the
    ffmpeg pipe writer; without ffmpeg "mp4" (there the JAX package's cv2
    mp4v channel) raises ValueError."""
    use_ffmpeg = ffmpeg.have_ffmpeg()
    _check_container(container, use_ffmpeg)
    device = resolve_device(device)
    t0 = time.time()
    codec = codec or DwtDctSvd()
    base = Path(output_dir)
    marked_dir = base / "marked_segments"
    marked_dir.mkdir(parents=True, exist_ok=True)

    segments = _segment(input_file, base / "segments", segment_duration, use_ffmpeg)
    logger.info("created %d segments", len(segments))

    def wm_for(i, frame_shape):
        return Shuffler(key=key).generate_wm(payload_for_segment_8bit(i),
                                             codec.wm_capacity(frame_shape))

    marked_files = _mark_all(segments, marked_dir, codec, wm_for, batch_size, quality,
                             container, device)
    original_results = _detect_all(marked_files, key, codec, device=device)

    # splice -> one re-encoded video -> re-segment on the same grid
    spliced = base / _splice_name(marked_files)
    concatenate_segments(marked_files, spliced)
    resegmented = _segment(spliced, base / "resegmented", segment_duration, use_ffmpeg)
    reencoded_results = _detect_all(resegmented, key, codec, device=device)
    return _analyze(original_results, reencoded_results, t0)


def _analyze(original_results, reencoded_results, t0):
    orig_ok = sum(r["success"] for r in original_results)
    re_ok = sum(r["success"] for r in reencoded_results)
    pairs = min(len(original_results), len(reencoded_results))
    matches = sum(
        1
        for i in range(pairs)
        if original_results[i]["success"] and reencoded_results[i]["success"]
    )
    seg_rate = matches / pairs if pairs else 0.0
    segment_preservation = {
        str(i): {
            "original_pattern": original_results[i]["pattern"],
            "original_success": original_results[i]["success"],
            "reencoded_pattern": reencoded_results[i]["pattern"],
            "reencoded_success": reencoded_results[i]["success"],
            "preserved": original_results[i]["success"] and reencoded_results[i]["success"],
        }
        for i in range(pairs)
    }
    report = {
        "original_success": orig_ok,
        "original_total": len(original_results),
        "original_success_rate": orig_ok / len(original_results) if original_results else 0,
        "original_avg_frequency": float(np.mean([r["frequency"] for r in original_results])) if original_results else 0,
        "reencoded_success": re_ok,
        "reencoded_total": len(reencoded_results),
        "reencoded_success_rate": re_ok / len(reencoded_results) if reencoded_results else 0,
        "reencoded_avg_frequency": float(np.mean([r["frequency"] for r in reencoded_results])) if reencoded_results else 0,
        "preservation_rate": re_ok / orig_ok if orig_ok else 0.0,
        "segment_matches": matches,
        "segment_pairs": pairs,
        "segment_preservation_rate": seg_rate,
        "segment_preservation": segment_preservation,
        "is_successful": seg_rate >= 0.75,
        "wall_seconds": time.time() - t0,
        "original_results": original_results,
        "reencoded_results": reencoded_results,
    }
    return report
