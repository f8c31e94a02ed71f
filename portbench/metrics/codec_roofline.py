"""The codec's share of its roofline, %: the least time of every codec call
in the window (its least bytes at the HBM peak, harness/roofline.py) over
all device time that is not a host<->device copy.  It counts the same work
whichever kernels or glue implement it."""

from harness import roofline


def read(s, suffix):
    nbytes = s.counters.get("codec_bytes", 0)
    if suffix != s.kind or not nbytes or s.noncopy_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(nbytes) / s.noncopy_s
