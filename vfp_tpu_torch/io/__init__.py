"""Frame I/O of the port: ``.rawv`` readers and writers (exact uint8 RGB).

Copied from the ``.rawv`` half of ``vfp_tpu/io/``; the other containers
there need cv2 or an ffmpeg binary, which the GPU machine lacks, and
``.y4m`` is lossy 4:2:0.  All readers yield frames in file byte order (RGB)
and all writers take the same.  ``images.py`` reads and writes the image
payloads: 8-bit grayscale PNG.
"""

from .readers import (  # noqa: F401
    RAWV_MAGIC,
    ArrayReader,
    FrameReader,
    RawVideoReader,
    open_reader,
)
from .writers import ArrayWriter, FrameWriter, RawVideoWriter, open_writer  # noqa: F401
from .images import read_png_gray, write_png_gray  # noqa: F401
