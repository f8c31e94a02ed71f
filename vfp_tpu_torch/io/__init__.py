"""Frame I/O of the port: readers and writers of uint8 RGB frames, and the
container helpers.

Copied from ``vfp_tpu/io/``: ``.rawv`` (exact uint8 RGB), MJPEG ``.avi``
(``avi.py``'s RIFF walking and splice, ``MjpegAviWriter``,
``MjpegAviReader``), ``.y4m`` (``y4m.py``: YUV4MPEG2 4:2:0, both ways),
MJPEG-in-MP4 ``.mp4``/``.m4s`` reads (``Mp4MjpegReader``) and ``mp4.py``,
the box-level MP4 library: parse, stream-copy concat, fMP4 fragments, audio
sidecars and MJPEG-AVI -> MP4 remux.  The native library codes every JPEG as
cv2 does.  ``io/ffmpeg.py`` and ``io/probe.py`` are not copied: they spawn
the ``ffmpeg``/``ffprobe`` binaries, which the GPU machine lacks, and so is
cv2's mp4v/H.264 codec (an ``.mp4`` whose video is not JPEG raises).  All
readers yield frames in file byte order (RGB) and all writers take the same.
``images.py`` reads and writes PNG and reads the pictures of ``cli
test-frame`` and ``--wm-image``.
"""

from .readers import (  # noqa: F401
    RAWV_MAGIC,
    ArrayReader,
    FrameReader,
    MjpegAviReader,
    Mp4MjpegReader,
    RawVideoReader,
    open_reader,
)
from .writers import (  # noqa: F401
    ArrayWriter,
    FrameWriter,
    MjpegAviWriter,
    RawVideoWriter,
    open_writer,
)
from .y4m import Y4MReader, Y4MWriter  # noqa: F401
from .images import (  # noqa: F401
    read_image_bgr,
    read_image_gray,
    read_png_gray,
    write_png,
    write_png_gray,
)
