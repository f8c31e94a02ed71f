"""HLS per-segment fingerprinting (port of ``vfp_tpu/fingerprint``): mark N
variants per segment, assemble a unique variant sequence per recipient,
trace leaks back to the recipient.  Where an ``ffmpeg`` binary is on PATH
the workflow takes the JAX package's ffmpeg route: ``.mp4`` segments and
variants, ``.m4s`` HLS fragments and an ``.mp4`` leak, all made by ffmpeg.
Without one, segments and variants are ``.rawv`` files for a ``.rawv``
source and MJPEG ``.avi`` for any other, with the source's audio in
per-segment sidecars, and leaks are ``.mp4`` when the audio rides along.
Every entry point that touches the card takes ``device=``
(default ``"cuda"``, raising without a GPU)."""

from .payloads import payload_for_segment, decode_segment_copy, pattern_string  # noqa: F401
from .segmenter import segment_video, frames_per_segment  # noqa: F401
from .marker import mark_segments, verify_segment, write_manifests, MarkedSegment  # noqa: F401
from .hls import write_hls_playlists, view_playlist, pattern_for_view  # noqa: F401
from .leak import select_copies, concatenate_segments, generate_leak, create_custom_hls  # noqa: F401
from .trace import trace_leak  # noqa: F401
