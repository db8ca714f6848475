"""VGG-16 trunk and fc6/fc7 recognition head (twin of densecap_tpu/models/vgg16.py).

The trunk runs NCHW tensors in `torch.channels_last` memory, so its
output permuted to NHWC is a free contiguous view for RoI align. Convs go
to cuDNN through `F.conv2d`; with `fuse=True` each conv followed by a
pool goes through kernel K3 (`ops/conv_pool.py`) instead.

Every module casts its weights to the compute dtype at use, as the JAX
package does. An inference model (`utils.checkpoint.to_torch`) stores
them in the compute dtype once, so the casts are no-ops; a training model
(`to_torch(..., train=True)`) stores f32 masters, and the gradients reach
them as f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import linear
from ..ops.conv_pool import conv_relu_pool, extent_mask
from ..ops.quant import QuantLinear

# (name, out_channels) per conv; 'M' = 2x2/2 max pool.
TRUNK1_CFG = [("conv1_1", 64), ("conv1_2", 64), "M",
              ("conv2_1", 128), ("conv2_2", 128), "M"]
TRUNK2_CFG = [("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
              ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
              ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)]


class Trunk(nn.Module):
    """A stack of 3x3 SAME conv + ReLU layers and 2x2/2 max pools.

    `convs` maps each conv name of `cfg` to (weight OIHW, bias).
    """

    def __init__(self, cfg, convs, compute_dtype):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.weights = nn.ParameterDict(
            {name: linear.frozen(w) for name, (w, _) in convs.items()})
        self.biases = nn.ParameterDict(
            {name: linear.frozen(b) for name, (_, b) in convs.items()})

    def forward(self, x, eh, ew, fuse=False):
        """x: (B, C, H, W) channels_last; eh / ew: (B,) f32 true extents.

        Activations past each image's extent are zeroed after every conv,
        so each conv's SAME padding reads exactly the zeros a run on the
        cropped image would read; at each pool the extent floor-halves and
        the map is masked again. Activations stay in the compute dtype;
        the output is upcast to f32 once, at the end. With `fuse`, each
        conv followed by a pool is one call of `conv_relu_pool` (K3 on the
        card), which computes the same conv -> ReLU -> mask -> pool ->
        mask.
        """
        cd = self.compute_dtype
        x = x.to(cd)
        i = 0
        while i < len(self.cfg):
            item = self.cfg[i]
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                eh, ew = torch.floor(eh / 2.0), torch.floor(ew / 2.0)
                x = x * extent_mask(x.shape[2], x.shape[3], eh, ew, x.dtype)
                i += 1
                continue
            name = item[0]
            w = self.weights[name].to(cd)
            b = self.biases[name].to(cd)
            if fuse and self.cfg[i + 1:i + 2] == ["M"]:
                x = conv_relu_pool(x, w, b, eh, ew)
                eh, ew = torch.floor(eh / 2.0), torch.floor(ew / 2.0)
                i += 2
                continue
            x = F.conv2d(x, w, padding=1)
            # bias added in the compute dtype, as the JAX trunk does
            x = torch.relu(x + b.view(1, -1, 1, 1))
            x = x * extent_mask(x.shape[2], x.shape[3], eh, ew, x.dtype)
            i += 1
        return x.float()


class Recog(nn.Module):
    """fc6 -> ReLU -> dropout -> fc7 -> ReLU -> dropout on flattened
    (7, 7, C) RoI features. Each layer is an `ops.linear.Linear` or, for
    int8 inference, a `QuantLinear` (JAX `apply_recog` dispatches the
    same way)."""

    def __init__(self, fc6, fc7, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc6, self.fc7 = fc6, fc7

    def forward(self, roi_feats, drop_prob=0.0, generator=None):
        """(N, 7, 7, C) -> (N, fc_dim) f32. drop_prob > 0 applies inverted
        dropout (keep with 1 - drop_prob, scale by 1 / (1 - drop_prob))
        after each ReLU, drawn from `generator`; a quantized layer refuses
        it, as training through it would starve its weights of gradient.
        The input is cast to the compute dtype first, so a quantized fc6
        sees the values the JAX quantizer sees."""
        cd = self.compute_dtype
        x = roi_feats.reshape(roi_feats.shape[0], -1).to(cd)
        for layer in (self.fc6, self.fc7):
            if drop_prob > 0 and isinstance(layer, QuantLinear):
                raise ValueError("quantized recog layers are inference-only")
            x = torch.relu(layer(x, cd))
            if drop_prob > 0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1.0 - drop_prob
                x = torch.where(keep, x / (1.0 - drop_prob), 0.0)
            x = x.to(cd)
        return x.float()


def feat_extent(h, w):
    """Feature extent of an (h, w) image under the 4-pool trunk: the floor
    chain of torch SpatialMaxPooling. h / w: float tensors -> int32."""
    for _ in range(4):
        h = torch.div(h, 2, rounding_mode="floor")
        w = torch.div(w, 2, rounding_mode="floor")
    return h.to(torch.int32), w.to(torch.int32)
