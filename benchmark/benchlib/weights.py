"""DenseCap's random weights from a seed, made on the device.

The tree has the names, shapes and layouts of the JAX package's
`init_params` (HWIO conv kernels, (in, out) linear weights, the LSTM in
torch-rnn's (i, f, o, g) gate order) and its init laws: He-normal trunk
convs, N(0, std) RPN and objectness heads, He-normal fc6 / fc7, uniform
LM matrices, zero biases, zero box-regression heads. All normal leaves
come from one `torch.randn` and all uniform ones from one `torch.rand`,
both drawn by a `torch.Generator` on the device, so the same seed gives
the same tree on the same device. The program and the reference each get
this tree: the program through `tree_numpy` (its weight bridge takes
numpy), the reference as device tensors.
"""

from __future__ import annotations

import numpy as np
import torch

TRUNK1 = [("conv1_1", 64), ("conv1_2", 64), "M",
          ("conv2_1", 128), ("conv2_2", 128), "M"]
TRUNK2 = [("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
          ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
          ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)]
NUM_ANCHORS = 12


def leaves(cfg):
    """[(path, shape, law, scale)] in a fixed order; law is "normal"
    (scale = std), "uniform" (U(-scale, scale)) or "zeros"."""
    out = []
    cin = 3
    for part, spec in (("trunk1", TRUNK1), ("trunk2", TRUNK2)):
        for item in spec:
            if item == "M":
                continue
            name, cout = item
            out.append((f"{part}/{name}/w", (3, 3, cin, cout), "normal",
                        (2.0 / (9 * cin)) ** 0.5))
            out.append((f"{part}/{name}/b", (cout,), "zeros", 0.0))
            cin = cout
    k, nf, std = NUM_ANCHORS, cfg["rpn_num_filters"], cfg["std"]
    out += [("rpn/conv/w", (3, 3, cin, nf), "normal", std),
            ("rpn/conv/b", (nf,), "zeros", 0.0),
            ("rpn/box/w", (1, 1, nf, 4 * k), "zeros", 0.0),
            ("rpn/box/b", (4 * k,), "zeros", 0.0),
            ("rpn/score/w", (1, 1, nf, 2 * k), "normal", std),
            ("rpn/score/b", (2 * k,), "zeros", 0.0)]
    in_dim = 7 * 7 * cin
    F = cfg["fc_dim"]
    out += [("recog/fc6/w", (in_dim, F), "normal", (2.0 / in_dim) ** 0.5),
            ("recog/fc6/b", (F,), "zeros", 0.0),
            ("recog/fc7/w", (F, F), "normal", (2.0 / F) ** 0.5),
            ("recog/fc7/b", (F,), "zeros", 0.0),
            ("objectness/w", (F, 1), "normal", std),
            ("objectness/b", (1,), "zeros", 0.0),
            ("box_reg/w", (F, 4), "zeros", 0.0),
            ("box_reg/b", (4,), "zeros", 0.0)]
    V, E, H = cfg["vocab_size"], cfg["rnn_encoding_size"], cfg["rnn_size"]
    hs = 1.0 / H ** 0.5
    out += [("lm/img_enc/w", (F, E), "uniform", 1.0 / F ** 0.5),
            ("lm/img_enc/b", (E,), "zeros", 0.0),
            ("lm/embed", (V + 2, E), "uniform", 0.01),
            ("lm/lstm/Wx", (E, 4 * H), "uniform", hs),
            ("lm/lstm/Wh", (H, 4 * H), "uniform", hs),
            ("lm/lstm/b", (4 * H,), "zeros", 0.0),
            ("lm/proj/w", (H, V + 1), "uniform", hs),
            ("lm/proj/b", (V + 1,), "zeros", 0.0)]
    return out


def _insert(tree, path, value):
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


class Weights:
    """The tree on `device`: `.tree` nests dicts of f32 tensors that are
    views of two buffers (normal and uniform draws) and zero leaves."""

    def __init__(self, cfg, seed, device):
        self.layout = leaves(cfg)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        sizes = {"normal": 0, "uniform": 0}
        for _, shape, law, _ in self.layout:
            if law in sizes:
                sizes[law] += int(np.prod(shape))
        self.buffers = {
            "normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen,
                                  device=device).mul_(2.0).sub_(1.0)}
        self.slices = {}
        self.tree = {}
        offset = {"normal": 0, "uniform": 0}
        for path, shape, law, scale in self.layout:
            if law == "zeros":
                leaf = torch.zeros(shape, device=device)
            else:
                n = int(np.prod(shape))
                start = offset[law]
                offset[law] += n
                self.slices[path] = (law, start, n, shape)
                leaf = self.buffers[law][start:start + n].view(shape)
                leaf.mul_(scale)
            _insert(self.tree, path, leaf)

    def tree_numpy(self):
        """The same tree as numpy f32 arrays: one copy per buffer."""
        host = {k: v.cpu().numpy() for k, v in self.buffers.items()}
        out = {}
        for path, shape, law, _ in self.layout:
            if law == "zeros":
                leaf = np.zeros(shape, np.float32)
            else:
                _, start, n, _ = self.slices[path]
                leaf = host[law][start:start + n].reshape(shape)
            _insert(out, path, leaf)
        return out


def flat(tree, prefix=""):
    """{"a/b/w": leaf} of a nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
