"""HLS playlist assembly over pre-marked segment variants (port of
``vfp_tpu/fingerprint/hls.py``).

Per-recipient fingerprinting is pure playlist text assembly over
already-marked variants: no media compute per view (reference:
api/main.py:216-253).  Where an ``ffmpeg`` binary is on PATH, every variant
is remuxed by ffmpeg into a standalone fMP4 ``.m4s`` exactly like the
reference (``mux_variant_to_m4s``, api/main.py:113-124).  Without one, an
``.mp4`` variant is fragmented at box level into an ``.m4s`` of the same
``empty_moov+frag`` shape with its audio sidecar muxed in, and any other
variant (``.rawv``, MJPEG ``.avi``) is copied into the HLS directory as it
is, with its sidecar beside it, so downloads keep the audio.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

from ..io import ffmpeg
from ..io.mp4 import audio_sidecar, fragment_mp4, read_mp4


def pattern_for_view(view_number: int, num_copies: int, num_segments: int) -> list:
    """Digits of view_number in base num_copies, one digit per segment
    (reference: api/main.py:221-232).

    When view_number overflows num_copies**num_segments the FIRST
    (most-significant) digits are kept, as the reference serves playlist
    entries only for segment files that exist (reference: api/main.py:220-250).
    With one copy every digit is 0 (the JAX function loops forever on a
    view number above 0 there)."""
    if num_copies < 1:
        raise ValueError(f"num_copies must be at least 1, got {num_copies}")
    if num_copies == 1:
        return [0] * num_segments
    digits = []
    v = view_number
    while v > 0:
        digits.append(v % num_copies)
        v //= num_copies
    while len(digits) < num_segments:
        digits.append(0)
    digits.reverse()
    return digits[:num_segments]


def _media_playlist(entries, segment_duration: float = 2.0, init_uri: str | None = None) -> str:
    out = ["#EXTM3U", "#EXT-X-VERSION:7",
           f"#EXT-X-TARGETDURATION:{int(round(segment_duration))}",
           "#EXT-X-MEDIA-SEQUENCE:0"]
    if init_uri:
        out.append(f'#EXT-X-MAP:URI="{init_uri}"')
    out.append("")
    for uri in entries:
        out.append(f"#EXTINF:{segment_duration:.1f},")
        out.append(str(uri))
    out.append("#EXT-X-ENDLIST")
    return "\n".join(out) + "\n"


def view_playlist(
    view_number: int,
    num_copies: int,
    segment_files: list,
    segment_duration: float = 2.0,
    uri_prefix: str = "",
    init_uri: str | None = None,
) -> tuple[str, list]:
    """(m3u8 text, copy pattern) for one recipient.

    ``segment_files`` is [segment][copy] -> filename.
    """
    pattern = pattern_for_view(view_number, num_copies, len(segment_files))
    entries = [f"{uri_prefix}{segment_files[i][c]}" for i, c in enumerate(pattern)]
    return _media_playlist(entries, segment_duration, init_uri), pattern


def mux_variant_to_m4s(marked_file, out_file):
    """Remux one marked variant into a standalone fMP4 fragment (reference:
    api/main.py:113-124). Requires ffmpeg."""
    subprocess.run(
        [
            "ffmpeg", "-loglevel", "quiet", "-y", "-i", str(marked_file),
            "-c:v", "copy", "-c:a", "copy",
            "-movflags", "+frag_keyframe+empty_moov+default_base_moof",
            "-f", "mp4", str(out_file),
        ],
        check=True,
    )


def write_hls_playlists(marked, hls_dir, copies: int, segment_duration: float = 2.0):
    """Populate hls_dir with per-variant media + base/master playlists.

    ``marked`` is the list of MarkedSegment from fingerprint.marker.
    Returns (master_path, playlist_path, segment_map, variant_files) where
    variant_files[seg][copy] = filename inside hls_dir.
    """
    hls_dir = Path(hls_dir)
    hls_dir.mkdir(parents=True, exist_ok=True)
    n_segments = 1 + max(m.segment_number for m in marked)
    variant_files = [[None] * copies for _ in range(n_segments)]
    segment_map = {}
    for m in marked:
        src = Path(m.file)
        sidecar = audio_sidecar(src)
        if ffmpeg.have_ffmpeg():
            name = f"marked_seg{m.segment_number:03d}_copy{m.copy_index}.m4s"
            mux_variant_to_m4s(src, hls_dir / name)
        elif src.suffix == ".mp4":
            # box-level fragmenting to a standalone fMP4, zero re-encode; the
            # sidecar's audio (if the segmenter made one) muxes into the .m4s
            name = f"marked_seg{m.segment_number:03d}_copy{m.copy_index}.m4s"
            extra = []
            if sidecar.exists():
                at = read_mp4(sidecar).audio()
                if at is not None:
                    extra.append(at)
            fragment_mp4(src, hls_dir / name, extra_tracks=extra)
        else:
            name = f"marked_seg{m.segment_number:03d}_copy{m.copy_index}{src.suffix}"
            shutil.copy2(src, hls_dir / name)
            if sidecar.exists():
                # audio rides into the serving dir so /download-view splices
                # keep it (service.download_view -> concatenate_segments)
                shutil.copy2(sidecar, audio_sidecar(hls_dir / name))
        variant_files[m.segment_number][m.copy_index] = name
        segment_map[name] = src.name

    playlist = _media_playlist(
        [variant_files[i][0] for i in range(n_segments)], segment_duration
    )
    (hls_dir / "playlist.m3u8").write_text(playlist)
    master = "#EXTM3U\n#EXT-X-VERSION:7\n#EXT-X-STREAM-INF:BANDWIDTH=2000000\nplaylist.m3u8\n"
    (hls_dir / "master.m3u8").write_text(master)
    return hls_dir / "master.m3u8", hls_dir / "playlist.m3u8", segment_map, variant_files
