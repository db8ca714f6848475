"""Mean device ms of GRiT's prefill per forward (the pool of each final
box, the object projection and the layers over the prefix, filling the
cache): the program's `textdec.prefix` span in the traced window."""

from benchlib.vitdet import span_mean_ms


def read(run):
    return span_mean_ms(run, "textdec.prefix")
