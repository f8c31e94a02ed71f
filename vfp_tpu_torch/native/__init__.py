"""Native (C++) ``.rawv`` streaming: off-GIL double-buffered frame reads and writes.

``vfpio.cpp`` is built with g++ at first use (``build.py``); ``io.open_reader``
and ``io.open_writer`` take the pure-Python reader and writer where there is
no g++.
"""

from .build import have_native, load_vfpio  # noqa: F401
from .io import NativeRawVideoReader, NativeRawVideoWriter  # noqa: F401
