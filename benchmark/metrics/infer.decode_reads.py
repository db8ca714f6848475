"""Mean host reads per greedy decode call (the `decode.reads` counter of
the `decode` span: one a step until every row has emitted END), in the
traced window."""

from benchlib.program_spans import counter


def read(run):
    return counter(run, "decode", "decode.reads", "n")
