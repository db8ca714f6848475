"""Mean device ms of the trunk (VGG-16, with K3 where fused) per forward:
the program's `trunk` span in the traced window."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "trunk")
