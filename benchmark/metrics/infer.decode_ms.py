"""Mean device ms of a greedy decode call: the program's `decode` span
in the traced window (`decode_ms.infer` times the same call from
outside)."""

from benchlib.program_spans import device_ms


def read(run):
    return device_ms(run, "decode")
