"""Mean device ms of the train step's forward and loss (`batched_loss`):
the program's `train.forward` span in the traced window."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "train.forward")
