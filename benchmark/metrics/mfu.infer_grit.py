"""The whole forward's share of the bf16 peak with GRiT's text decoder:
the hand FLOP count of each call in the traced window (`benchlib.grit
.inference_flops`, at the decode steps its captions took) over the
window's length."""

from benchlib import grit
from benchlib.readers import mfu_pct


def read(run):
    B = int(run.workload["inputs"]["batch"])
    return mfu_pct(run, sum(grit.inference_flops(run.cfg, B, s)["total"]
                            for s in run.counters.get("decode_steps", [])))
