"""Model and training configuration, free of JAX.

Twin of `densecap_tpu.config.DenseCapConfig` restricted to the fields the
port's inference and training paths read, under the same names and
defaults. `compute_dtype` is a torch dtype. `from_json` reads what the JAX
`to_json` writes (the dtype as a name such as "bfloat16"); fields that
only TPU-specific options use are dropped. What `to_json` writes, the
JAX `from_json` reads.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import torch

# The 12 DenseCap anchor (width, height) pairs (densecap_tpu/ops/transforms.py).
DENSECAP_ANCHORS = (
    (45, 90), (90, 45), (64, 64),
    (90, 180), (180, 90), (128, 128),
    (181, 362), (362, 181), (256, 256),
    (362, 724), (724, 362), (512, 512),
)

# VGG-16 receptive-field geometry (x0, y0, sx, sy): centres at 8.5, stride 16.
VGG16_FIELD_CENTERS = (8.5, 8.5, 16.0, 16.0)

# VGG-mean BGR pixel offsets (the canvas is BGR-ordered).
VGG_MEAN_BGR = (103.939, 116.779, 123.68)


@dataclasses.dataclass(frozen=True)
class DenseCapConfig:
    vocab_size: int = 1000
    seq_length: int = 15
    image_size: int = 720

    output_height: int = 7
    output_width: int = 7
    fc_dim: int = 4096
    drop_prob: float = 0.5
    field_centers: Tuple[float, float, float, float] = VGG16_FIELD_CENTERS

    rpn_filter_size: int = 3
    rpn_num_filters: int = 256
    zero_box_conv: bool = True
    std: float = 0.01
    anchor_scale: float = 1.0
    anchors: Tuple[Tuple[int, int], ...] = DENSECAP_ANCHORS

    # sampler
    sampler_batch_size: int = 256
    sampler_high_thresh: float = 0.7
    sampler_low_thresh: float = 0.3
    train_remove_outbounds_boxes: bool = True

    # loss weights and decays
    mid_box_reg_weight: float = 0.05
    mid_objectness_weight: float = 0.1
    end_box_reg_weight: float = 0.1
    end_objectness_weight: float = 0.1
    captioning_weight: float = 1.0
    box_reg_decay: float = 5e-5
    weight_decay: float = 1e-6

    rnn_size: int = 512
    rnn_encoding_size: int = 512

    # gt padding: ground-truth rows per image
    max_gt_boxes: int = 128

    test_rpn_nms_thresh: float = 0.7
    test_final_nms_thresh: float = 0.3
    test_max_proposals: int = 1000
    clip_final_boxes: bool = False
    # NMS runs over the top-k scored proposals only (-1 = all anchors)
    test_pre_nms_topk: int = 6000

    # run trunk1's conv1_2+pool1 and conv2_2+pool2 through kernel K3
    # (ops/conv_pool.py); off by default, as in the JAX package
    fuse_conv_pool: bool = False

    # conv/matmul operand dtype; parameters and accumulations stay f32
    compute_dtype: torch.dtype = torch.bfloat16

    # run trunk2 without gradient (the trainer sets it until the
    # finetune flip); trunk1 never has one
    static_freeze_cnn: bool = False

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)

    def anchor_tensor(self, device) -> torch.Tensor:
        return (torch.tensor(self.anchors, dtype=torch.float32, device=device)
                * self.anchor_scale)

    def replace(self, **kw) -> "DenseCapConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["compute_dtype"] = str(self.compute_dtype).removeprefix("torch.")
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "DenseCapConfig":
        d = json.loads(s)
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in names}
        if "compute_dtype" in d:
            dt = getattr(torch, d["compute_dtype"], None)
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"unknown compute_dtype {d['compute_dtype']!r}")
            d["compute_dtype"] = dt
        if "anchors" in d:
            d["anchors"] = tuple(tuple(a) for a in d["anchors"])
        if "field_centers" in d:
            d["field_centers"] = tuple(d["field_centers"])
        return cls(**d)
