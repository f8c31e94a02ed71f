"""Device ms per input batch in the profiler's ``Memcpy HtoD`` and ``Memcpy DtoH``."""


def read(s, suffix):
    batches = s.counters.get("batches", 0)
    copies = s.htod_s + s.dtoh_s
    if suffix != s.kind or not batches or copies <= 0:
        return None
    return copies * 1e3 / batches
