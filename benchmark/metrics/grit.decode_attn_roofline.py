"""The decode steps' attention's share of its roofline: the least time of
a call's steps' attention (`benchlib.grit.decode_attn_least_ms`: every
layer's keys and values up to each step's column read once in bf16, each
step's q read and output written, at 3.35 TB/s), at the steps each call
took, over the device ms a call in the `textdec.attn` spans.

A span's device time runs from the stream reaching its start marker to
it reaching its end marker. Where the host paces the steps, as under the
trace, the stream reaches the start marker before the attention's launch
is enqueued, so the span holds that launch's host time as well as the
kernel's: the reading is then a floor of the kernel's own share, and a
faster kernel moves it only as far as the launch allows
(`chip_smoke.py`'s `[grit]` phase times the attention alone at the
cell's shape)."""

import statistics

from benchlib.grit import decode_attn_least_ms, per_call_ms


def read(run):
    ms = per_call_ms(run, "textdec.attn")
    steps = run.counters.get("decode_steps")
    if not ms or not steps:
        return None
    B = int(run.workload["inputs"]["batch"])
    least = statistics.fmean(decode_attn_least_ms(run.cfg, B, s)
                             for s in steps)
    return 100.0 * least / ms
