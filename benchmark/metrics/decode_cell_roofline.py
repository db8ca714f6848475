"""K5's share of its roofline: the least time of one greedy decode LSTM
step at the cell's shape over the mean time of `lstm_cell_kernel` in the
trace. The least time counts the work any implementation of the step must
do: P = batch x test_max_proposals rows, E = rnn_encoding_size inputs,
H = rnn_size units; 2 P (E + H) 4H bf16 operations; bytes: x's rows, h
and c read in f32, [Wx ; Wh] in bf16 and b in f32 read once, h and c
written in f32. A program without K5 gives None."""

from benchlib import roofline
from benchlib.readers import kernel_roofline_pct


def least_ms(P, E, H):
    F = roofline.F32
    nbytes = (P * E * F + 2 * P * H * F + (E + H) * 4 * H * 2 + 4 * H * F
              + 2 * P * H * F)
    return roofline.least_ms(nbytes, 2 * P * (E + H) * 4 * H, "bf16_flops")


def read(run):
    cfg = run.cfg
    P = int(run.workload["inputs"]["batch"]) * int(cfg["test_max_proposals"])
    least, _ = least_ms(P, int(cfg["rnn_encoding_size"]), int(cfg["rnn_size"]))
    return kernel_roofline_pct(run, "lstm_cell_kernel", least)
