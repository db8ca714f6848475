"""Mean device ms of the train step's backward: the program's
`train.backward` span in the traced window."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "train.backward")
