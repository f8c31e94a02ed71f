"""Container metadata probe (copied from ``vfp_tpu/io/probe.py``; reference:
src/offmark/common/__video.py:12-23).

With an ``ffprobe`` binary on PATH, its JSON stream list, asked for with the
JAX module's argv.  Without one, the header as the port's own readers parse
it (``.rawv``, MJPEG ``.avi``, MJPEG-in-MP4 ``.mp4``/``.m4s``, ``.y4m``): the
counterpart of the JAX module's cv2 half for the containers the port reads.
Returns ``{'width', 'height'}`` plus ``fps`` and ``frames`` where known.  A
file that cannot be probed raises IOError (the JAX module lets ffprobe's
CalledProcessError through).
"""

from __future__ import annotations

import json
import shutil
import subprocess


def probe(video_file) -> dict:
    if shutil.which("ffprobe"):
        try:
            out = subprocess.run(
                [
                    "ffprobe", "-v", "quiet", "-print_format", "json",
                    "-show_streams", str(video_file),
                ],
                capture_output=True, check=True,
            ).stdout
            info = json.loads(out)
            vs = next(s for s in info["streams"] if s.get("codec_type") == "video")
        except (subprocess.CalledProcessError, ValueError, KeyError, StopIteration) as e:
            raise IOError(f"ffprobe cannot read a video stream from {video_file}: {e!r}") from e
        d = {"width": int(vs["width"]), "height": int(vs["height"])}
        if "r_frame_rate" in vs and "/" in vs["r_frame_rate"]:
            num, den = vs["r_frame_rate"].split("/")
            if float(den):
                d["fps"] = float(num) / float(den)
        if "nb_frames" in vs:
            d["frames"] = int(vs["nb_frames"])
        return d
    return _probe_own(video_file)


def _probe_own(video_file) -> dict:
    """The header through the port's own readers (never the ffmpeg pipe,
    whose reader probes)."""
    from .readers import _open_own_reader

    try:
        reader = _open_own_reader(video_file)
    except ValueError as e:  # a container the port does not read
        raise IOError(str(e)) from e
    try:
        d = {"width": reader.width, "height": reader.height, "fps": reader.fps}
        if reader.n_frames is not None:
            d["frames"] = reader.n_frames
        return d
    finally:
        reader.close()
