"""VGG-16 trunk and fc6/fc7 recognition head (twin of densecap_tpu/models/vgg16.py).

The trunk runs NCHW tensors in `torch.channels_last` memory, so its
output permuted to NHWC is a free contiguous view for RoI align. Convs go
to cuDNN through `F.conv2d`. Weights are held in the compute dtype (the
JAX package casts its f32 parameters at every call, to the same values).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (name, out_channels) per conv; 'M' = 2x2/2 max pool.
TRUNK1_CFG = [("conv1_1", 64), ("conv1_2", 64), "M",
              ("conv2_1", 128), ("conv2_2", 128), "M"]
TRUNK2_CFG = [("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
              ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
              ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)]


def frozen(t):
    return nn.Parameter(t, requires_grad=False)


def dot_f32(x, w):
    """2-D `x @ w` with operands in `w`'s dtype and an f32 result.

    The twin of `jnp.dot(x.astype(cd), w.astype(cd),
    preferred_element_type=float32)`: bf16 operands, f32 accumulation,
    f32 output. On the CPU the bf16 operands are widened to f32, which is
    exact, so the products and the f32 sum are the same.
    """
    x = x.to(w.dtype)
    if w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _extent_mask(H, W, eh, ew, dtype):
    """(B, 1, H, W) mask: 1 inside each image's (eh, ew) extent, else 0."""
    dev = eh.device
    rows = torch.arange(H, dtype=torch.float32, device=dev)[None] < eh[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None] < ew[:, None]
    return (rows[:, None, :, None] & cols[:, None, None, :]).to(dtype)


class Trunk(nn.Module):
    """A stack of 3x3 SAME conv + ReLU layers and 2x2/2 max pools.

    `convs` maps each conv name of `cfg` to (weight OIHW, bias), both in
    the compute dtype.
    """

    def __init__(self, cfg, convs):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict(
            {name: frozen(w) for name, (w, _) in convs.items()})
        self.biases = nn.ParameterDict(
            {name: frozen(b) for name, (_, b) in convs.items()})

    def forward(self, x, eh, ew):
        """x: (B, C, H, W) channels_last; eh / ew: (B,) f32 true extents.

        Activations past each image's extent are zeroed after every conv,
        so each conv's SAME padding reads exactly the zeros a run on the
        cropped image would read; at each pool the extent floor-halves and
        the map is masked again. Activations stay in the compute dtype;
        the output is upcast to f32 once, at the end.
        """
        for item in self.cfg:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                eh, ew = torch.floor(eh / 2.0), torch.floor(ew / 2.0)
            else:
                name = item[0]
                w = self.weights[name]
                x = F.conv2d(x.to(w.dtype), w, padding=1)
                # bias added in the compute dtype, as the JAX trunk does
                x = torch.relu(x + self.biases[name].view(1, -1, 1, 1))
            x = x * _extent_mask(x.shape[2], x.shape[3], eh, ew, x.dtype)
        return x.float()


class Recog(nn.Module):
    """fc6 -> ReLU -> fc7 -> ReLU on flattened (7, 7, C) RoI features.

    Inference only: dropout is the identity. Weights (in, out) in the
    compute dtype, biases f32.
    """

    def __init__(self, w6, b6, w7, b7):
        super().__init__()
        self.w6, self.b6 = frozen(w6), frozen(b6)
        self.w7, self.b7 = frozen(w7), frozen(b7)

    def forward(self, roi_feats):
        """(N, 7, 7, C) -> (N, fc_dim) f32."""
        cd = self.w6.dtype
        x = roi_feats.reshape(roi_feats.shape[0], -1).to(cd)
        x = torch.relu(dot_f32(x, self.w6) + self.b6).to(cd)
        x = torch.relu(dot_f32(x, self.w7) + self.b7).to(cd)
        return x.float()


def feat_extent(h, w):
    """Feature extent of an (h, w) image under the 4-pool trunk: the floor
    chain of torch SpatialMaxPooling. h / w: float tensors -> int32."""
    for _ in range(4):
        h = torch.div(h, 2, rounding_mode="floor")
        w = torch.div(w, 2, rounding_mode="floor")
    return h.to(torch.int32), w.to(torch.int32)
