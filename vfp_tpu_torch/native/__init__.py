"""Native (C++) host code: off-GIL double-buffered ``.rawv`` and command-pipe
reads and writes (``vfpio.cpp``) and the baseline JPEG codec of the MJPEG
``.avi`` files (``jpeg.cpp``, equal to cv2's libjpeg-turbo).

Both are built into one library with g++ at first use (``build.py``);
``io.open_reader`` and ``io.open_writer`` take the pure-Python ``.rawv``
reader and writer where there is no g++.  JPEG has no pure-Python stand-in.
"""

from .build import have_native, load_vfpio  # noqa: F401
from .io import (NativePipeReader, NativePipeWriter, NativeRawVideoReader,  # noqa: F401
                 NativeRawVideoWriter)
from .jpeg import decode_jpeg, decode_jpegs, encode_jpeg, encode_jpegs  # noqa: F401
