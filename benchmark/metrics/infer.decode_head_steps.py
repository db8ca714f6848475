"""Mean greedy decode steps per call whose vocab head ran as one launch
of kernel K4 (the `decode.head_steps` counter of the `decode` span), in
the traced window. A program without that counter gives None."""

from benchlib import program_spans


def read(run):
    s = program_spans.window_summary(run, "decode")
    if s is None or "decode.head_steps" not in s["counters"]:
        return None
    return float(s["counters"]["decode.head_steps"]["n"])
