"""Mean device ms of recognition per forward (fc6 and fc7, the objectness
and box heads): the program's `recog` span in the traced window."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "recog")
