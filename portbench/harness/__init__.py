"""The benchmark's harness: cells from ``BENCHMARK.json``, sources and
sinks, the drivers that hand the program its work, spans, the profiler
summary and the check against the plain reference."""
