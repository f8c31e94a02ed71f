"""Host ms per input batch inside the program's batch calls: ``FrameMarker.mark``,
``FrameExtractor.extract``, or ``MultiMarker.submit`` plus ``collect``
(harness spans around the calls)."""


def read(s, suffix):
    batches = s.counters.get("batches", 0)
    if suffix != s.kind or not batches or "batch_call" not in s.span_s:
        return None
    return (s.span_s["batch_call"] + s.span_s.get("collect", 0.0)) * 1e3 / batches
