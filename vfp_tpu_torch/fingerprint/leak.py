"""Leak simulation: pick one variant per segment, splice into one video
(port of ``vfp_tpu/fingerprint/leak.py``).

(reference: tests/generate_leak.py:59-141,426-461)

Splices are stream copies where the containers allow.  Where an ``ffmpeg``
binary is on PATH, an ``.mp4`` leak is ffmpeg's concat-demuxer stream copy
(``io/ffmpeg.py:concat_mp4_ffmpeg``) and the default leak is
``leaked_video.mp4``, as in the JAX module.  Without one, as in the JAX
module without ffmpeg: ``.mp4``/``.m4s`` variants into an ``.mp4`` by
box-level concat, MJPEG ``.avi`` variants into an ``.mp4`` by remuxing
their JPEG chunks as ``jpeg`` samples with their audio sidecars muxed back
(``io/mp4.py``), MJPEG ``.avi`` into an ``.avi`` by chunk copy
(``io/avi.py``); anything else is frame-level, through the reader/writer
stack.  The leak is then ``leaked_video.mp4`` when every chosen variant has
an audio sidecar, else ``leaked_video`` with the variants' own suffix
(``.rawv`` for ``.rawv`` variants).
"""

from __future__ import annotations

import json
import random
import re
from pathlib import Path

from ..io import ffmpeg, open_reader, open_writer
from ..io.mp4 import audio_sidecar, concat_mp4, read_mp4, track_from_mjpeg_avi, write_mp4
from .hls import _media_playlist


def select_copies(segment_copies_info: dict, marked_dir, pattern: str | None = None, random_seed=None):
    """One variant per segment by explicit digit pattern or seeded random
    (reference: tests/generate_leak.py:59-108). Returns (files, copy_pattern)."""
    if random_seed is not None:
        random.seed(random_seed)
    segments = segment_copies_info["segments"]
    order = sorted(int(s) for s in segments)
    files, copy_pattern = [], []
    if pattern is not None:
        if len(pattern) < len(order):
            raise ValueError(f"pattern '{pattern}' too short for {len(order)} segments")
        for i, seg in enumerate(order):
            variants = segments[str(seg)]
            c = int(pattern[i]) % len(variants)
            copy_pattern.append(c)
            files.append(Path(marked_dir) / variants[c]["file"])
    else:
        for seg in order:
            variants = segments[str(seg)]
            c = random.randint(0, len(variants) - 1)
            copy_pattern.append(c)
            files.append(Path(marked_dir) / variants[c]["file"])
    return files, copy_pattern


def _mux_avis_to_mp4(segment_files, output_file):
    """MJPEG-AVI segments -> one standard ``.mp4``: their JPEG chunks become
    ``jpeg`` samples (stream copy) and their sidecars' audio muxes back."""
    video = audio = None
    for seg in segment_files:
        vt = track_from_mjpeg_avi(seg)
        if video is None:
            video = vt
        else:
            video.samples.extend(vt.samples)
        sc = audio_sidecar(seg)
        if sc.exists():
            at = read_mp4(sc).audio()
            if at is not None:
                if audio is None:
                    audio = at
                else:
                    audio.samples.extend(at.samples)
    write_mp4(output_file, [video] + ([audio] if audio is not None else []))


def concatenate_segments(segment_files, output_file):
    """Splice segments into one file, stream-copy first (the reference's
    ``-c copy``, tests/generate_leak.py:126-136): ffmpeg's concat into an
    ``.mp4`` where the binary is on PATH; without it, box-level concat of
    ``.mp4``/``.m4s`` segments into an ``.mp4``, JPEG-chunk remux of MJPEG
    ``.avi`` segments (and their sidecar audio) into an ``.mp4``, chunk copy
    of MJPEG ``.avi`` segments into an ``.avi``.  An ``.mp4`` output is made
    by remux only: a remux that fails raises its IOError.  Anything else is
    spliced frame by frame through the reader/writer stack (one generation,
    like a screen-recorder leak)."""
    if str(output_file).endswith(".mp4"):
        if ffmpeg.have_ffmpeg():
            ffmpeg.concat_mp4_ffmpeg(segment_files, output_file)
            return output_file
        # .m4s variants (the fMP4 shape write_hls_playlists emits) parse
        # through the same box-level path, so download_view splices never
        # drop muxed audio
        if all(str(s).endswith((".mp4", ".m4s")) for s in segment_files):
            concat_mp4(segment_files, output_file)
            return output_file
        if all(str(s).endswith(".avi") for s in segment_files):
            _mux_avis_to_mp4(segment_files, output_file)
            return output_file
        raise ValueError(f"an .mp4 leak is a remux of .mp4/.m4s or MJPEG .avi segments, "
                         f"not of {sorted({Path(s).suffix for s in segment_files})}")
    if str(output_file).endswith(".avi"):
        from ..io.avi import splice_mjpeg_avis

        if splice_mjpeg_avis(segment_files, output_file):
            return output_file
    first = open_reader(segment_files[0])
    w, h, fps = first.width, first.height, first.fps
    first.close()
    with open_writer(output_file, w, h, fps) as writer:
        for seg in segment_files:
            with open_reader(seg) as r:
                while True:
                    b = r.read_batch(32)
                    if b is None:
                        break
                    writer.write_batch(b)
    return output_file


def create_custom_hls(base_dir, pattern: list, hls_dir=None, segment_duration: float = 2.0):
    """Per-pattern HLS playback bundle over the existing variant media: a
    pattern-specific media playlist + master + a CORS http server script + an
    hls.js player page (reference: tests/generate_leak.py:195-424).

    Returns the custom playlist path.  Zero re-encoding — playlist assembly
    only, like the serving path.
    """
    base_dir = Path(base_dir)
    hls_dir = Path(hls_dir) if hls_dir else base_dir / "hls"
    if not hls_dir.exists():
        raise FileNotFoundError(f"HLS directory not found at {hls_dir}")
    names = sorted(f.name for f in hls_dir.iterdir() if "copy" in f.name)
    by_seg: dict = {}
    for n in names:
        m = re.search(r"seg(\d+)_copy(\d+)", n)
        if m:
            by_seg.setdefault(int(m.group(1)), {})[int(m.group(2))] = n
    pattern_str = "".join(map(str, pattern))
    entries = [by_seg[s][c] for s, c in zip(sorted(by_seg), pattern)]
    playlist = hls_dir / f"custom_playlist_{pattern_str}.m3u8"
    playlist.write_text(_media_playlist(entries, segment_duration))
    master = hls_dir / f"custom_master_{pattern_str}.m3u8"
    master.write_text(
        "#EXTM3U\n#EXT-X-VERSION:7\n#EXT-X-STREAM-INF:BANDWIDTH=2000000\n"
        f"{playlist.name}\n"
    )
    (hls_dir / "cors_server.py").write_text(
        '"""CORS-enabled static server for local HLS playback."""\n'
        "from functools import partial\n"
        "from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer\n\n\n"
        "class Handler(SimpleHTTPRequestHandler):\n"
        "    def end_headers(self):\n"
        "        self.send_header('Access-Control-Allow-Origin', '*')\n"
        "        self.send_header('Cache-Control', 'no-cache')\n"
        "        super().end_headers()\n\n\n"
        "if __name__ == '__main__':\n"
        "    ThreadingHTTPServer(('0.0.0.0', 8000), Handler).serve_forever()\n"
    )
    (hls_dir / "index.html").write_text(
        "<!doctype html><html><body><h1>Leaked pattern "
        f"{pattern_str}</h1><video id=v controls width=640></video>\n"
        '<script src="https://cdn.jsdelivr.net/npm/hls.js@latest"></script>\n'
        "<script>const h=new Hls();"
        f"h.loadSource('{playlist.name}');h.attachMedia(document.getElementById('v'));"
        "</script></body></html>\n"
    )
    return playlist


def generate_leak(
    copies_file,
    output_file=None,
    pattern: str | None = None,
    random_seed=None,
    marked_dir=None,
    create_hls: bool = False,
    segment_duration: float = 2.0,
):
    """End-to-end leak generation; writes leak_info.json next to the output
    (reference: tests/generate_leak.py:426-461). Returns (output_file, info)."""
    copies_file = Path(copies_file)
    info = json.loads(copies_file.read_text())
    base = copies_file.parent
    marked_dir = Path(marked_dir) if marked_dir else base / "marked_segments"
    files, copy_pattern = select_copies(info, marked_dir, pattern, random_seed)
    if output_file is None:
        # with ffmpeg: its concat; else .mp4 carries the audio sidecars back
        # in, or the variants' own container keeps the chunk-level splice
        ext = (".mp4" if ffmpeg.have_ffmpeg()
               or (files and all(audio_sidecar(f).exists() for f in files))
               else Path(files[0]).suffix)
        output_file = base / f"leaked_video{ext}"
    concatenate_segments(files, output_file)
    leak_info = {
        "copy_pattern": copy_pattern,
        "pattern_string": "".join(map(str, copy_pattern)),
        "selected_segments": [Path(f).name for f in files],
    }
    if create_hls:
        try:
            playlist = create_custom_hls(base, copy_pattern, segment_duration=segment_duration)
            leak_info["custom_hls_playlist"] = playlist.name
            leak_info["playback_instructions"] = {
                "step1": "Start the CORS-enabled HTTP server",
                "command": f"cd {playlist.parent} && python cors_server.py",
                "step2": "Open the following URL in your browser",
                "url": "http://localhost:8000/index.html",
                "step3": "The video will play with your specific watermark pattern",
            }
        except FileNotFoundError:
            pass
    (Path(output_file).parent / "leak_info.json").write_text(json.dumps(leak_info, indent=2))
    return Path(output_file), leak_info
