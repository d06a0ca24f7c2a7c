"""Device ms of the evaluation step's float32 loss (the program's
``task.loss`` span: its VAE encodes and U-Net forward) per step."""

from perfbench import program_spans


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.mean_device_ms(spans, "task.loss") if spans else None
