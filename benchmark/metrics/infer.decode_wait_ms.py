"""Mean host ms a greedy decode call spends blocked in its host reads
(the `decode.reads` counter's time, inside the `decode` span), in the
traced window."""

from benchlib.program_spans import counter


def read(run):
    return counter(run, "decode", "decode.reads", "host_ms")
