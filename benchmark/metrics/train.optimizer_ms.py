"""Mean device ms of the train step's update (the gradients' fill-in,
weight decay and Adam): the program's `train.optimizer` span in the
traced window (`train.adam_ms` times Adam alone from outside)."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "train.optimizer")
