"""The train step's share of the bf16 peak: the hand FLOP count of a
frozen step times the steps in the traced window, over its length."""

from benchlib import flops
from benchlib.readers import mfu_pct


def read(run):
    w = run.workload["batch"]
    S = int(w["canvas"])
    per = flops.train_flops(run.cfg, int(w["size"]), S, S, False)["total"]
    return mfu_pct(run, per * run.counters.get("steps", 0))
