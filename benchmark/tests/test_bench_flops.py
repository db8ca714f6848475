"""The frozen FLOP count equals scripts/torch_mfu_estimate.py's at the
cells' shapes, and the K2 / K2b roofline functions reproduce PERF.md's
"Bound ms" of the kernel table."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import flops, roofline  # noqa: E402

CFG = json.loads((BENCH / "configs" /
                  "densecap_vgg16_720_p1000.json").read_text())
# the webcam deployment's shapes (reference webcam demo: 480 px, 50
# proposals), for a serving cell to come
WEBCAM = dict(CFG, image_size=480, test_max_proposals=50)


def script():
    sys.path.insert(0, str(ROOT / "scripts"))
    sys.path.insert(0, str(ROOT))
    import torch_mfu_estimate as m
    import torch_tool_common as tc

    return m, tc


def program_cfg(cfg):
    m, tc = script()
    import torch

    from densecap_tpu_torch.config import DenseCapConfig

    return DenseCapConfig(
        vocab_size=cfg["vocab_size"], seq_length=cfg["seq_length"],
        image_size=cfg["image_size"],
        test_max_proposals=cfg["test_max_proposals"], fc_dim=cfg["fc_dim"],
        rnn_size=cfg["rnn_size"], rnn_encoding_size=cfg["rnn_encoding_size"],
        rpn_num_filters=cfg["rpn_num_filters"],
        sampler_batch_size=cfg["sampler_batch_size"],
        max_gt_boxes=cfg["max_gt_boxes"], compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("cfg,B,H,W,steps", [
    (CFG, 8, 720, 544, 15), (CFG, 8, 720, 720, 15), (CFG, 8, 720, 544, 7),
    (WEBCAM, 1, 480, 480, 15), (WEBCAM, 8, 480, 480, 15)])
def test_inference_flops_match_the_script(cfg, B, H, W, steps):
    m, _ = script()
    assert (flops.inference_flops(cfg, B, H, W, steps)
            == m.inference_flops(program_cfg(cfg), B, H, W, steps))


@pytest.mark.parametrize("finetune", [False, True])
def test_train_flops_match_the_script(finetune):
    m, _ = script()
    ours = flops.train_flops(CFG, 8, 720, 720, finetune)
    theirs = m.train_flops(program_cfg(CFG), 8, 720, 720, finetune)
    assert ours == theirs


def test_decode_steps_match_the_script():
    import numpy as np

    m, _ = script()
    caps = np.array([[3, 4, 10001, 10001], [5, 10001, 10001, 10001]])
    assert flops.decode_steps(caps, 10001, 15) == m.decode_steps(caps, 10001,
                                                                  15) == 3


# PERF.md, kernel table: K2 8x1000 on (8, 45, 45, 512), K2b 8x384 on the
# same map, positions alone and with d feats (bytes-bound). The table's
# K2b rows count the small position tensors unevenly; every byte read or
# written once lands within 0.3% of them.
@pytest.mark.parametrize("fn,bound,rel", [
    (lambda: roofline.roi_align_fwd(8, 45, 45, 512, 8000), 0.2497, 2e-4),
    (lambda: roofline.roi_align_bwd(8, 45, 45, 512, 3072, False), 0.1019,
     4e-3),
    (lambda: roofline.roi_align_bwd(8, 45, 45, 512, 3072, True), 0.1119,
     4e-3)])
def test_roofline_reproduces_the_kernel_table(fn, bound, rel):
    ms, by = fn()
    assert by == "bytes"
    assert ms == pytest.approx(bound, rel=rel)
