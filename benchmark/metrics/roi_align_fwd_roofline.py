"""K2's share of its roofline: the least time of the cell's shape
(`benchlib.roofline.roi_align_fwd`: B x proposals RoIs on the canvas's
feature map) over the mean time of `roi_align_fwd_kernel` in the trace."""

from benchlib import roofline
from benchlib.flops import feature_hw
from benchlib.readers import kernel_roofline_pct


def read(run):
    w = run.workload["inputs"]
    B = int(w["batch"])
    Hf, Wf = feature_hw(*w["canvas"])
    least, _ = roofline.roi_align_fwd(B, Hf, Wf, 512,
                                      B * run.cfg["test_max_proposals"])
    return kernel_roofline_pct(run, "roi_align_fwd_kernel", least)
