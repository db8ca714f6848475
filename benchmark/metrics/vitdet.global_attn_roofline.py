"""The global attention core's share of its roofline: the least time of
one global block's core at the cell's shape (`benchlib.vitdet
.global_attn_least_ms`: 4 B h N^2 d + 4 B h N S d operations at the bf16
peak; q, k, v and the output in bf16 once each) over the mean device
time of a `vit.attn.global` span. It reads the same work whatever
implements it."""

from benchlib.vitdet import global_attn_least_ms, span_mean_ms


def read(run):
    ms = span_mean_ms(run, "vit.attn.global")
    if not ms:
        return None
    B = int(run.workload["inputs"]["batch"])
    return 100.0 * global_attn_least_ms(run.cfg, B) / ms
