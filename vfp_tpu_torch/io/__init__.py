"""Frame I/O of the port: exact ``.rawv`` and MJPEG ``.avi`` readers and
writers.

Copied from ``vfp_tpu/io/``: ``.rawv`` (exact uint8 RGB), and MJPEG ``.avi``
(``avi.py``'s RIFF walking and splice, ``MjpegAviWriter``,
``MjpegAviReader``), whose JPEGs the native library codes as cv2 does.  The
other containers there need cv2's mp4v encoder or an ffmpeg binary, which
the GPU machine lacks, and ``.y4m`` is lossy 4:2:0.  All readers yield
frames in file byte order (RGB) and all writers take the same.
``images.py`` reads and writes PNG (the image payloads: 8-bit grayscale) and
reads the picture of ``cli test-frame``.
"""

from .readers import (  # noqa: F401
    RAWV_MAGIC,
    ArrayReader,
    FrameReader,
    MjpegAviReader,
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
from .images import read_image_bgr, read_png_gray, write_png, write_png_gray  # noqa: F401
