"""The whole forward's share of the bf16 peak: the hand FLOP count of
each call in the traced window (at the decode steps its captions took)
over the window's length."""

from benchlib.readers import infer_flops, mfu_pct


def read(run):
    return mfu_pct(run, infer_flops(run))
