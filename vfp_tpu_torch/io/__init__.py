"""Frame I/O of the port: readers and writers of uint8 RGB frames, and the
container helpers.

Copied from ``vfp_tpu/io/``: ``.rawv`` (exact uint8 RGB), MJPEG ``.avi``
(``avi.py``'s RIFF walking and splice, ``MjpegAviWriter``,
``MjpegAviReader``), ``.y4m`` (``y4m.py``: YUV4MPEG2 4:2:0, both ways),
MJPEG-in-MP4 ``.mp4``/``.m4s`` reads (``Mp4MjpegReader``), ``mp4.py``, the
box-level MP4 library (parse, stream-copy concat, fMP4 fragments, audio
sidecars and MJPEG-AVI -> MP4 remux), and ``ffmpeg.py``/``probe.py``, the
ffmpeg route.  A host with an ``ffmpeg`` binary on PATH (``have_ffmpeg``)
takes that route as the JAX package does: every container but ``.rawv`` and
``.y4m`` is read through an rgb24 pipe (H.264 among them) and frames go to
``.mp4`` (or any suffix but ``.rawv``, ``.avi``, ``.y4m``) through one.  A
host without it reads and writes the port's own containers, and an ``.mp4``
whose video is not JPEG raises.  The native library codes every JPEG as cv2
does.  All readers yield frames in file byte order (RGB) and all writers
take the same.  ``images.py`` reads and writes PNG and reads the pictures of
``cli test-frame`` and ``--wm-image``.
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
from .probe import probe  # noqa: F401
from .ffmpeg import (  # noqa: F401
    FFmpegPipeReader,
    FFmpegPipeWriter,
    have_ffmpeg,
)
