"""Mean host ms of the engine's ``engine.estimate`` spans less their
``engine.wait`` child: the host's own work in an estimate."""

from perfbench import program_spans


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.estimate_host_ms(spans) if spans else None
