"""Model and training configuration, free of JAX.

Twin of `densecap_tpu.config.DenseCapConfig` restricted to the fields the
port's inference and training paths read, under the same names and
defaults. `compute_dtype` is a torch dtype. `from_json` reads what the JAX
`to_json` writes (the dtype as a name such as "bfloat16"); fields that
only TPU-specific options use are dropped. What `to_json` writes for a
config the JAX package can run (VGG-16, the LSTM, every final box kept),
the JAX `from_json` reads; the `trunk` and `vit_*` fields (a ViTDet
trunk), `lm` and `textdec_*` (GRiT's text decoder) and
`test_final_max_boxes` are the port's own.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

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

# The trunks: VGG-16 (the reference's) and ViTDet's plain ViT with its
# simple feature pyramid's stride-16 level (`models/vitdet.py`).
TRUNKS = ("vgg16", "vitdet_b")

# The language models: DenseCap's LSTM (`models/lstm.py`) and GRiT's text
# decoder (`models/textdec.py`).
LMS = ("lstm", "grit_textdec")

# Fields the JAX package's config does not have.
PORT_ONLY = ("trunk", "vit_", "lm", "textdec_", "test_final_max_boxes")


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
    # rows an image the final NMS keeps (None: test_max_proposals)
    test_final_max_boxes: Optional[int] = None
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

    # the trunk (TRUNKS); the vit_* fields shape the ViTDet one and
    # default to ViTDet-B (Li et al., arXiv:2203.16527), whose input is a
    # vit_img_size square and whose stride-16 features have
    # vit_out_channels channels
    trunk: str = "vgg16"
    vit_img_size: int = 1024
    vit_patch_size: int = 16
    vit_embed_dim: int = 768
    vit_depth: int = 12
    vit_num_heads: int = 12
    vit_mlp_ratio: float = 4.0
    vit_window_size: int = 14
    vit_global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    vit_pretrain_grid: int = 14
    vit_out_channels: int = 256

    # the language model (LMS); the textdec_* fields shape GRiT's text
    # decoder (Wu et al., arXiv:2212.00280) and default to its BERT-base
    # widths: layers, width, heads, FFN width, rows of the position
    # table, and the side of the RoI grid pooled for its object tokens
    lm: str = "lstm"
    textdec_layers: int = 6
    textdec_dim: int = 768
    textdec_heads: int = 12
    textdec_ffn: int = 3072
    textdec_positions: int = 40
    textdec_obj_pool: int = 14

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)

    def anchor_tensor(self, device) -> torch.Tensor:
        return (torch.tensor(self.anchors, dtype=torch.float32, device=device)
                * self.anchor_scale)

    def __post_init__(self):
        if self.trunk not in TRUNKS:
            raise ValueError(f"unknown trunk {self.trunk!r} (expected one "
                             f"of {', '.join(TRUNKS)})")
        if self.lm not in LMS:
            raise ValueError(f"unknown lm {self.lm!r} (expected one of "
                             f"{', '.join(LMS)})")

    def replace(self, **kw) -> "DenseCapConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_vit(self) -> bool:
        return self.trunk != "vgg16"

    @property
    def is_textdec(self) -> bool:
        return self.lm == "grit_textdec"

    def to_json(self) -> str:
        """The JAX `from_json` reads the JSON of a config it can run, which
        leaves out the port's own fields (`PORT_ONLY`)."""
        d = dataclasses.asdict(self)
        d["compute_dtype"] = str(self.compute_dtype).removeprefix("torch.")
        if not (self.is_vit or self.is_textdec
                or self.test_final_max_boxes is not None):
            d = {k: v for k, v in d.items() if not k.startswith(PORT_ONLY)}
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
        if "vit_global_blocks" in d:
            d["vit_global_blocks"] = tuple(d["vit_global_blocks"])
        return cls(**d)
