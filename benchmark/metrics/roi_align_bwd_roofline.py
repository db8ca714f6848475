"""K2b's share of its roofline with trunk2 frozen (the positions-only
instance): the least time of B x (sampler + positives) RoIs on the
canvas's feature map over the mean time of `roi_align_bwd_kernel`."""

from benchlib import roofline
from benchlib.flops import feature_hw
from benchlib.readers import kernel_roofline_pct


def read(run):
    w, cfg = run.workload["batch"], run.cfg
    B = int(w["size"])
    Hf, Wf = feature_hw(int(w["canvas"]), int(w["canvas"]))
    rois = B * (cfg["sampler_batch_size"] + cfg["sampler_batch_size"] // 2)
    least, _ = roofline.roi_align_bwd(B, Hf, Wf, 512, rois, d_feats=False)
    return kernel_roofline_pct(run, "roi_align_bwd_kernel", least)
