"""Mean device ms of localization per forward (RPN, the top-k, K1, K2):
the program's `localize` span in the traced window."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "localize")
