"""Attention cores a forward that ran as one launch of kernel K6: the
`vit.attn.k6` counter of the `vit.attn.global` and `vit.attn.window`
spans, summed over a call's spans and averaged over the calls' `trunk`
spans, in the traced window. A program without that counter (before
K6; the CPU) gives None."""

from benchlib.program_spans import window_summary

SPANS = ("vit.attn.global", "vit.attn.window")
COUNTER = "vit.attn.k6"


def read(run):
    calls = window_summary(run, "trunk")
    if calls is None:
        return None
    found = [s for s in (window_summary(run, name) for name in SPANS)
             if s is not None and COUNTER in s["counters"]]
    if not found:
        return None
    return sum(s["counters"][COUNTER]["n"] * s["count"]
               for s in found) / calls["count"]
