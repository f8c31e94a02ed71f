"""The 95th percentile over the window's segments of the time from the
source handing over a segment's frames to the collector holding every copy
of it (host clock): what a live packager waits for."""


def read(s, suffix):
    return s.extras.get("segment_p95_ms")
