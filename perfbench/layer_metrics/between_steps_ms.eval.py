"""Mean host ms between one step's device work done (the end of the
program's ``eval.wait`` span) and the next step's start (``eval.step``):
the read-back, the loader's pull and the host-to-device copy, while the
device has nothing queued."""

from perfbench import program_spans


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.between_steps_ms(spans) if spans else None
