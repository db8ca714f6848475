"""The weight bridge: numpy parameter trees in, the port's module out.

  * `load_params(path)`: numpy twin of `densecap_tpu.utils.checkpoint
    .load_params` (`/`-joined keys, `__extra__/` entries).
  * `init_params(cfg, seed)`: a numpy tree with the names, shapes and
    init laws of `densecap_tpu.models.densecap.init_params`, from a
    seeded `numpy.random.Generator` (not JAX's random values).
  * `to_torch(params, cfg, device)`: builds `DenseCap` from such a tree,
    whether an `.npz` or JAX's `init_params` (via `np.asarray`) made it.

Layouts: JAX conv kernels are HWIO and become OIHW; linear weights stay
(in, out); the LSTM keeps torch-rnn's (i, f, o, g) gate order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.densecap import DenseCap
from ..models.lstm import LanguageModel
from ..models.rpn import RPN
from ..models.vgg16 import TRUNK1_CFG, TRUNK2_CFG, Recog, Trunk


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params(path):
    """Load an `.npz` written by the JAX `save_params`. Returns (params, extra)."""
    flat, extra = {}, {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            if k.startswith("__extra__/"):
                extra[k[len("__extra__/"):]] = data[k]
            else:
                flat[k] = data[k]
    return _unflatten(flat), extra


def init_params(cfg, seed=0):
    """Random parameters with the JAX package's tree, names, shapes and laws."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def uniform(shape, scale):
        return rng.uniform(-scale, scale, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def trunk(spec, cin):
        out = {}
        for item in spec:
            if item == "M":
                continue
            name, cout = item
            # He-normal fan-in, zero bias (vgg16.py:_conv_init)
            out[name] = {"w": normal((3, 3, cin, cout),
                                     (2.0 / (9 * cin)) ** 0.5),
                         "b": zeros(cout)}
            cin = cout
        return out, cin

    trunk1, c1 = trunk(TRUNK1_CFG, 3)
    trunk2, c2 = trunk(TRUNK2_CFG, c1)
    k, nf, fs = cfg.num_anchors, cfg.rpn_num_filters, cfg.rpn_filter_size
    rpn = {
        "conv": {"w": normal((fs, fs, c2, nf), cfg.std), "b": zeros(nf)},
        "box": {"w": (zeros(1, 1, nf, 4 * k) if cfg.zero_box_conv
                      else normal((1, 1, nf, 4 * k), cfg.std)),
                "b": zeros(4 * k)},
        "score": {"w": normal((1, 1, nf, 2 * k), cfg.std),
                  "b": zeros(2 * k)},
    }
    in_dim = cfg.output_height * cfg.output_width * c2
    F = cfg.fc_dim
    recog = {"fc6": {"w": normal((in_dim, F), (2.0 / in_dim) ** 0.5),
                     "b": zeros(F)},
             "fc7": {"w": normal((F, F), (2.0 / F) ** 0.5), "b": zeros(F)}}
    V, W, H = cfg.vocab_size, cfg.rnn_encoding_size, cfg.rnn_size
    hs = 1.0 / H ** 0.5
    lm = {
        "img_enc": {"w": uniform((F, W), 1.0 / F ** 0.5), "b": zeros(W)},
        "embed": uniform((V + 2, W), 0.01),
        "lstm": {"Wx": uniform((W, 4 * H), hs), "Wh": uniform((H, 4 * H), hs),
                 "b": zeros(4 * H)},
        "proj": {"w": uniform((H, V + 1), hs), "b": zeros(V + 1)},
    }
    return {
        "trunk1": trunk1, "trunk2": trunk2, "rpn": rpn, "recog": recog,
        "objectness": {"w": normal((F, 1), cfg.std), "b": zeros(1)},
        "box_reg": {"w": zeros(F, 4), "b": zeros(4)},
        "lm": lm,
    }


def to_torch(params, cfg, device):
    """Numpy (or array-like) parameter tree -> `DenseCap` on `device`."""
    cd = cfg.compute_dtype

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def conv(p, bias_dtype):
        w = t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)), cd)
        return (w.contiguous(memory_format=torch.channels_last),
                t(p["b"], bias_dtype))

    def linear(p):
        return t(p["w"], cd), t(p["b"])

    def trunk(spec, tree):
        return Trunk(spec, {item[0]: conv(tree[item[0]], cd)
                            for item in spec if item != "M"})

    rp, lm = params["rpn"], params["lm"]
    model = DenseCap(
        cfg,
        trunk(TRUNK1_CFG, params["trunk1"]),
        trunk(TRUNK2_CFG, params["trunk2"]),
        RPN(conv(rp["conv"], torch.float32), conv(rp["box"], torch.float32),
            conv(rp["score"], torch.float32)),
        Recog(*linear(params["recog"]["fc6"]),
              *linear(params["recog"]["fc7"])),
        linear(params["objectness"]),
        linear(params["box_reg"]),
        LanguageModel(*linear(lm["img_enc"]), t(lm["embed"]),
                      t(lm["lstm"]["Wx"], cd), t(lm["lstm"]["Wh"], cd),
                      t(lm["lstm"]["b"]), *linear(lm["proj"])),
    )
    return model.eval()
