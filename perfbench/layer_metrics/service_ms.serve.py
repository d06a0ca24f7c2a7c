"""Mean service time of the engine's calls: an estimate's host ms, a
registration's larger of its host and device ms (``engine.estimate``,
``engine.register``)."""

from perfbench import program_spans


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.service_ms(spans) if spans else None
