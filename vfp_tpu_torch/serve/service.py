"""Business logic of the fingerprinting service, transport-agnostic (port of
``vfp_tpu/serve/service.py``).

Upload -> segment -> N watermarked variants per segment -> per-view
playlist assembly (the view number in base ``num_copies``), persisted in
``view_history.json``, and leak detection that maps a leaked segment back to
usernames.  Serving a view does no media computation: it is playlist text
over the pre-marked variants.  Marking and detection run on ``device``
(default ``"cuda"``, raising without a GPU); the JSON files and response
fields are the JAX service's.  Uploads and leaks may come in any container
the port reads: where an ``ffmpeg`` binary is on PATH, whatever its pipe
opens; without one ``.rawv``, MJPEG ``.avi``, MJPEG-in-MP4 ``.mp4``/``.m4s``
or ``.y4m``.  One it cannot read (another suffix, a corrupt file, an MP4
whose video the route cannot decode, one cut short part way) is refused
with an ``OSError`` before the served state is touched.  Segments follow
``segment_video``: ``.mp4`` by ffmpeg where it is on PATH; else ``.rawv``
for a ``.rawv`` upload and MJPEG ``.avi`` otherwise, with the upload's
audio in sidecars.  A download is an ``.mp4`` (ffmpeg's concat of the
``.m4s`` variants where it is on PATH) that carries the audio when every
segment has it.
"""

from __future__ import annotations

import json
import logging
import shutil
import struct
import subprocess
import threading
import uuid
from collections import Counter
from datetime import datetime
from pathlib import Path

import numpy as np

from ..fingerprint import decode_segment_copy, mark_segments, pattern_for_view, segment_video
from ..fingerprint.hls import _media_playlist, write_hls_playlists
from ..fingerprint.leak import concatenate_segments
from ..fingerprint.marker import MarkedSegment, _read_all
from ..fingerprint.payloads import payload_for_segment
from ..io import open_reader
from ..io.mp4 import audio_sidecar
from ..io.readers import RAWV_MAGIC, require_supported
from ..pipeline import cached_bit_extractor
from ..utils.device import resolve_device
from ..wm import DwtDctSvd

logger = logging.getLogger(__name__)


def _check_upload(path) -> None:
    """Raise ``OSError`` unless the port reads ``path``: an upload the service
    cannot read is the client's error.  A ``.rawv`` must hold one or more
    whole frames after its header; any other container's first frame must
    decode (through the ffmpeg pipe where the binary is on PATH)."""
    path = Path(path)
    try:
        require_supported(path)
    except ValueError as e:
        raise IOError(str(e)) from e
    if path.suffix == ".rawv":
        with open(path, "rb") as f:
            head = f.read(24)
        if len(head) < 24 or head[:8] != RAWV_MAGIC:
            raise IOError(f"not a VFP raw video file: {path.name}")
        w, h = struct.unpack("<II", head[8:16])
        body = path.stat().st_size - 24
        if w * h == 0 or body <= 0 or body % (w * h * 3):
            raise IOError(f"{path.name}: no whole {w}x{h} frames after the header")
        return
    try:
        reader = open_reader(path)
    except (ValueError, struct.error) as e:  # a header the reader cannot parse
        raise IOError(f"{path.name}: {e}") from e
    try:
        if reader.read_batch(1) is None:
            raise IOError(f"{path.name}: no frames")
    finally:
        reader.close()


class VfpService:
    def __init__(self, data_dir, num_copies: int = 3, segment_duration: float = 2.0, key: int = 0,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.num_copies = num_copies
        self.segment_duration = segment_duration
        self.key = key
        self.codec = DwtDctSvd()
        # ThreadingHTTPServer handles requests concurrently; view_history.json
        # updates are read-modify-write and must be serialized.
        self._history_lock = threading.Lock()

    # -- paths ---------------------------------------------------------------
    @property
    def hls_dir(self) -> Path:
        return self.data_dir / "hls"

    @property
    def history_file(self) -> Path:
        return self.data_dir / "view_history.json"

    @property
    def mapping_file(self) -> Path:
        return self.data_dir / "segment_mapping.json"

    def _load_history(self) -> dict:
        if self.history_file.exists():
            return json.loads(self.history_file.read_text())
        return {}

    def _load_mapping(self) -> dict:
        if not self.mapping_file.exists():
            raise FileNotFoundError("No processed video found. Please upload a video first.")
        return json.loads(self.mapping_file.read_text())

    # -- upload / processing ---------------------------------------------------
    def process_upload(self, video_path) -> dict:
        """Segment + mark num_copies variants per segment + build the HLS dir.

        Returns a summary dict; writes segment_mapping.json in the API
        flavour ('successful_segments').  The upload is checked and segmented
        into a staging directory BEFORE the previous video's state is wiped: a
        bad upload, one that is cut short or corrupt part way too, must not
        take down the served HLS."""
        _check_upload(video_path)
        staging = self.data_dir / "segments.incoming"
        if staging.exists():
            shutil.rmtree(staging)
        try:
            staged = segment_video(video_path, staging, self.segment_duration)
        except (OSError, ValueError, struct.error, subprocess.CalledProcessError) as e:
            shutil.rmtree(staging, ignore_errors=True)
            if isinstance(e, OSError):
                raise
            raise IOError(f"{Path(video_path).name}: {e}") from e
        for d in ("segments", "marked_segments"):
            p = self.data_dir / d
            if p.exists():
                shutil.rmtree(p)
        staging.rename(self.data_dir / "segments")
        segments = [self.data_dir / "segments" / p.name for p in staged]
        marked, payloads, copies, failed = self._mark_with_fallback(segments)
        master, playlist, seg_map, variants = write_hls_playlists(
            marked, self.hls_dir, copies=self.num_copies,
            segment_duration=self.segment_duration,
        )
        successful = {}
        for m in marked:
            name = next(k for k, v in seg_map.items() if v == Path(m.file).name)
            successful[name] = {
                "segment_number": m.segment_number,
                "copy_index": m.copy_index,
                "payload": m.payload,
                "file_path": str(self.hls_dir / name),
            }
        self.mapping_file.write_text(
            json.dumps(
                {
                    "successful_segments": successful,
                    "num_copies": self.num_copies,
                    "description": "Maps segment numbers to their watermarked versions",
                },
                indent=2,
            )
        )
        (self.data_dir / "segment_payloads.json").write_text(json.dumps(payloads, indent=2))
        (self.data_dir / "segment_copies.json").write_text(json.dumps(copies, indent=2))
        if failed:
            (self.data_dir / "failed_segments.json").write_text(json.dumps(failed, indent=2))
        return {
            "status": "success",
            "num_segments": len(segments),
            "num_copies": self.num_copies,
            "total_variants": len(marked),
            "failed_segments": failed,
        }

    def _mark_with_fallback(self, segments):
        """Mark per segment, falling back to unmarked copies when a segment
        fails to mark, so playback never breaks."""
        marked, payloads = [], {}
        copies_info = {"segments": {}}
        failed = []
        out_dir = self.data_dir / "marked_segments"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, seg in enumerate(segments):
            try:
                m, p, c = mark_segments(
                    [seg], out_dir, copies=self.num_copies, key=self.key,
                    first_segment_number=i, device=self.device,
                )
                marked.extend(m)
                payloads.update(p)
                copies_info["segments"].update(c["segments"])
            except Exception as e:
                logger.error("segment %d failed to mark (%s); using unmarked copies", i, e)
                failed.append({"segment_number": i, "error": str(e)})
                ext = Path(seg).suffix
                entry = []
                for copy_index in range(self.num_copies):
                    out = out_dir / f"marked_seg{i}_copy{copy_index}{ext}"
                    shutil.copy2(seg, out)
                    payload = payload_for_segment(i, copy_index)
                    marked.append(MarkedSegment(str(out), i, copy_index, payload.tolist()))
                    payloads[f"{i}_{copy_index}"] = payload.tolist()
                    entry.append(
                        {"file": out.name, "payload": payload.tolist(), "copy_index": copy_index}
                    )
                copies_info["segments"][str(i)] = entry
        copies_info.update(
            {
                "total_segments": len(segments),
                "copies_per_segment": self.num_copies,
                "total_marked_segments": len(marked),
            }
        )
        return marked, payloads, copies_info, failed

    # -- views ------------------------------------------------------------------
    def _num_segments(self, mapping: dict) -> int:
        return 1 + max(v["segment_number"] for v in mapping["successful_segments"].values())

    def _variant_name(self, mapping: dict, seg: int, copy: int) -> str | None:
        for name, info in mapping["successful_segments"].items():
            if info["segment_number"] == seg and info["copy_index"] == copy:
                return name
        return None

    def _view_files(self, view: dict, mapping: dict) -> list:
        """The variant names of a view's sequence, in segment order."""
        pattern = pattern_for_view(view["view_number"], view["num_copies"], view["num_segments"])
        names = (self._variant_name(mapping, i, c) for i, c in enumerate(pattern))
        return [n for n in names if n is not None]

    def start_view(self, username: str, num_copies: int | None = None) -> dict:
        if not username:
            raise ValueError("Username is required")
        with self._history_lock:
            return self._start_view_locked(username, num_copies)

    def _start_view_locked(self, username: str, num_copies: int | None) -> dict:
        num_copies = num_copies or self.num_copies
        mapping = self._load_mapping()
        history = self._load_history()
        view_number = len(history)
        num_segments = self._num_segments(mapping)
        pattern = pattern_for_view(view_number, num_copies, num_segments)
        segment_patterns = {}
        for i, c in enumerate(pattern):
            name = self._variant_name(mapping, i, c)
            if name is not None:
                segment_patterns[name] = mapping["successful_segments"][name]
        view_id = str(uuid.uuid4())
        history[view_id] = {
            "username": username,
            "timestamp": datetime.now().isoformat(),
            "view_number": view_number,
            "num_copies": num_copies,
            "num_segments": num_segments,
            "segment_patterns": segment_patterns,
            "segment_mapping": {
                "successful_segments": segment_patterns,
                "num_copies": num_copies,
                "description": "Maps segment numbers to their watermarked versions",
            },
        }
        self.history_file.write_text(json.dumps(history, indent=2))
        return {
            "status": "success",
            "view_id": view_id,
            "view_number": view_number,
            "num_copies": num_copies,
            "num_segments": num_segments,
            "segment_patterns": segment_patterns,
        }

    def view_playlist(self, view_id: str, uri_prefix: str = "/hls/") -> str:
        """The view's own m3u8 over the shared variants."""
        history = self._load_history()
        if view_id not in history:
            raise KeyError(view_id)
        names = self._view_files(history[view_id], self._load_mapping())
        return _media_playlist([f"{uri_prefix}{n}" for n in names], self.segment_duration)

    def view_history(self) -> dict:
        return self._load_history()

    def download_view(self, view_id: str) -> Path:
        """The view's variant sequence spliced into one file: an ``.mp4`` of
        ``.m4s`` variants (ffmpeg's concat where the binary is on PATH, else
        the box-level one), or of MJPEG ``.avi`` ones that all have their
        audio sidecar (the audio muxed back), else the variants' own
        container."""
        view = self._load_history()[view_id]
        files = [self.hls_dir / n for n in self._view_files(view, self._load_mapping())]
        ext = files[0].suffix if files and files[0].suffix in (".avi", ".rawv") else ".mp4"
        if ext == ".avi" and all(audio_sidecar(f).exists() for f in files):
            ext = ".mp4"
        out = self.data_dir / f"view_{view_id}{ext}"
        concatenate_segments(files, out)
        return out

    # -- leak detection -----------------------------------------------------------
    def detect(self, leaked_path) -> dict:
        """Identify which users' views a leaked segment came from: the
        majority payload of its frames (16 at a time, all submitted before
        the first is collected) names the segment and copy."""
        history = self._load_history()
        if not history:
            return {"error": "No view history found"}
        try:
            frames, _ = _read_all(leaked_path)
        except (ValueError, struct.error) as e:  # another suffix, a header cut short
            raise IOError(str(e)) from e
        fx = cached_bit_extractor(self.codec, self.key, 8, 16, device=self.device)
        handles = [fx.submit(frames[s: s + 16]) for s in range(0, len(frames), 16)]
        payloads = np.concatenate([fx.collect(h) for h in handles])
        pattern, count = Counter(map(tuple, payloads.tolist())).most_common(1)[0]
        frequency = count / len(payloads)
        segment_number, copy_index = decode_segment_copy(np.array(pattern))
        if segment_number is None:
            return {"error": "Could not decode watermark pattern"}
        matches = []
        for view_id, view in history.items():
            pat = pattern_for_view(view["view_number"], view["num_copies"], view["num_segments"])
            if segment_number < len(pat) and pat[segment_number] == copy_index:
                # every field the detect page reads from a match
                matches.append(
                    {
                        "view_id": view_id,
                        "username": view["username"],
                        "view_number": view["view_number"],
                        "timestamp": view.get("timestamp", ""),
                        "payload": list(map(int, pattern)),
                        "segment_number": int(segment_number),
                        "copy_index": int(copy_index),
                        "frequency": float(frequency),
                    }
                )
        return {
            "status": "success" if matches else "no_match",
            "segment_number": segment_number,
            "copy_index": copy_index,
            "frequency": frequency,
            "pattern": list(map(int, pattern)),
            "matches": matches,
        }
