"""The prefill's share of its roofline: its least time at the cell's
shape (`benchlib.grit.prefix_least_ms`: the prefill's operations at the
bf16 peak) over the mean device time of a `textdec.prefix` span. It reads
the same work whatever implements it."""

from benchlib.grit import prefix_least_ms
from benchlib.vitdet import span_mean_ms


def read(run):
    ms = span_mean_ms(run, "textdec.prefix")
    if not ms:
        return None
    B = int(run.workload["inputs"]["batch"])
    return 100.0 * prefix_least_ms(run.cfg, B) / ms
