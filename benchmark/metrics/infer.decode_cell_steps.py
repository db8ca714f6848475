"""Mean greedy decode LSTM steps per call that ran as one launch of kernel
K5 (the `decode.cell_steps` counter of the `decode` span: the image's
step and each token's), in the traced window. A program without that
counter gives None."""

from benchlib import program_spans


def read(run):
    s = program_spans.window_summary(run, "decode")
    if s is None or "decode.cell_steps" not in s["counters"]:
        return None
    return float(s["counters"]["decode.cell_steps"]["n"])
