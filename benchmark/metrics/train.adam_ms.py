"""Mean ms of the optimizer's step (`trainer.opt.step`), by CUDA events
around each call in the traced window."""

from benchlib.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "adam_ms")
