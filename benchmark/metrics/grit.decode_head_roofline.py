"""K4's share of its roofline at the text decoder's head: the least time
of one decode step's vocab head at the cell's shape over the mean time of
`greedy_head_kernel` in the trace. P = batch x final rows an image (the
final NMS's cut), K = textdec_dim, V + 1 classes; operations and bytes
as `decode_head_roofline` counts them at the LSTM's head. A program
without K4 gives None."""

from benchlib import roofline
from benchlib.grit import final_rows
from benchlib.readers import kernel_roofline_pct


def read(run):
    cfg = run.cfg
    P = int(run.workload["inputs"]["batch"]) * final_rows(cfg)
    K, N = int(cfg["textdec_dim"]), int(cfg["vocab_size"]) + 1
    nbytes = (P * K * roofline.F32 + K * N * 2 + N * roofline.F32
              + P * (8 + roofline.I32 + roofline.F32 + 2))
    least, _ = roofline.least_ms(nbytes, 2 * P * K * N, "bf16_flops")
    return kernel_roofline_pct(run, "greedy_head_kernel", least)
