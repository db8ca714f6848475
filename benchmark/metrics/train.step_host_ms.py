"""Mean host ms of a train step, the time the host takes to enqueue it:
the program's `train.step` span in the traced window."""

from benchlib.program_spans import host_ms


def read(run):
    return host_ms(run, "train.step")
