"""Mean greedy decode steps per forward whose vocab head ran as one launch
of kernel K4 (the `decode.head_steps` counter of the `textdec.decode`
span), in the traced window. A program without that span or counter
gives None."""

from benchlib import program_spans


def read(run):
    s = program_spans.window_summary(run, "textdec.decode")
    if s is None or "decode.head_steps" not in s["counters"]:
        return None
    return float(s["counters"]["decode.head_steps"]["n"])
