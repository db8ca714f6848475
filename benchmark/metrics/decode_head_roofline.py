"""K4's share of its roofline: the least time of one greedy decode step's
vocab head at the cell's shape over the mean time of `greedy_head_kernel`
in the trace. P = batch x test_max_proposals rows, K = rnn_size, V + 1
classes: 2 P K (V + 1) bf16 operations; bytes: h in f32, W in bf16 and
b in f32 read once, and per row the token (int64), the seq (int32) and
logprob (f32) entries written and `done` read and written. A program
without K4 gives None."""

from benchlib import roofline
from benchlib.readers import kernel_roofline_pct


def read(run):
    cfg = run.cfg
    P = int(run.workload["inputs"]["batch"]) * int(cfg["test_max_proposals"])
    K, N = int(cfg["rnn_size"]), int(cfg["vocab_size"]) + 1
    nbytes = (P * K * roofline.F32 + K * N * 2 + N * roofline.F32
              + P * (8 + roofline.I32 + roofline.F32 + 2))
    least, _ = roofline.least_ms(nbytes, 2 * P * K * N, "bf16_flops")
    return kernel_roofline_pct(run, "greedy_head_kernel", least)
