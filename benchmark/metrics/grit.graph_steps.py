"""Mean greedy decode steps per forward whose layer work replayed CUDA
graphs (the `textdec.graph_steps` counter of the `textdec.decode` span),
in the traced window. A program without that span or counter gives
None."""

from benchlib import program_spans


def read(run):
    s = program_spans.window_summary(run, "textdec.decode")
    if s is None or "textdec.graph_steps" not in s["counters"]:
        return None
    return float(s["counters"]["textdec.graph_steps"]["n"])
