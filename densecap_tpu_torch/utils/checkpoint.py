"""The weight bridge: numpy parameter trees in, the port's module out.

  * `load_params(path)`: numpy twin of `densecap_tpu.utils.checkpoint
    .load_params` (`/`-joined keys, `__extra__/` entries), and
    `load_checkpoint(path)`, which also reads the `meta` entry and the
    config in it, as the CLIs and the server do.
  * `init_params(cfg, seed)`: a numpy tree with the names, shapes and
    init laws of `densecap_tpu.models.densecap.init_params`, from a
    seeded `numpy.random.Generator` (not JAX's random values).
  * `to_torch(params, cfg, device, train=False)`: builds `DenseCap` from
    such a tree, whether an `.npz` or JAX's `init_params` (via
    `np.asarray`) made it. For inference every weight is stored in the
    compute dtype once; with `train=True` every parameter is an f32
    master that the modules cast at use, and all but trunk1's take
    gradients.
  * `from_torch(model)`: the reverse, a numpy tree with the JAX package's
    names and layouts, and `save_params(path, tree, extra)`, which writes
    it as the `.npz` that the JAX `load_params` and `load_params` here
    read.
  * `save_train_state(prefix, trainer, it, meta)` /
    `load_train_state(prefix, cfg, device)`: a training run's pair,
    `<prefix>.npz` (the parameters as above) and `<prefix>.optim.pt`
    (`Trainer.state_dict()` and the iteration, `torch.save`), which the
    train CLI's `--checkpoint_start_from` resumes from.

A tree that `ops.quant.quantize_for_inference` (or the JAX package's, as
numpy) has quantized builds an int8 inference model: each quantized layer
becomes a `QuantLinear` whose codes stay int8 and whose scales and bias
stay f32. `to_torch(..., train=True)` refuses such a tree, and
`from_torch` takes full-precision models only.

Layouts: JAX conv kernels are HWIO and become OIHW; linear weights stay
(in, out); the LSTM keeps torch-rnn's (i, f, o, g) gate order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import DenseCapConfig
from ..models.densecap import DenseCap
from ..models.lstm import LanguageModel
from ..models.rpn import RPN
from ..models.vgg16 import TRUNK1_CFG, TRUNK2_CFG, Linear, Recog, Trunk
from ..ops.quant import QuantLinear, is_quantized


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def save_params(path, params, extra=None):
    """Write a numpy parameter tree as one `.npz` with `/`-joined keys and
    `__extra__/<name>` entries (the JAX `save_params` layout)."""
    flat = _flatten(params)
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def save_train_state(prefix, trainer, it, meta):
    """Write a training run's pair: `<prefix>.npz` (the model, with
    `meta` under `__extra__/meta`) and `<prefix>.optim.pt`
    (`trainer.state_dict()` and `iter`)."""
    save_params(prefix + ".npz", from_torch(trainer.model),
                extra={"meta": meta})
    torch.save(dict(trainer.state_dict(), iter=int(it)), prefix + ".optim.pt")


def load_train_state(prefix, cfg, device):
    """Read the pair of `save_train_state` -> (model, state): the training
    model of `<prefix>.npz` built with `cfg` on `device`, and the
    `.optim.pt` dict, whose "iter" is the saved iteration; the rest is for
    `Trainer.load_state_dict`. The Adam state loads onto the CPU and
    `Trainer.load_state_dict` moves it to the parameters' device, keeping
    each count on the CPU, as a fresh Adam has it."""
    params, _ = load_params(prefix + ".npz")
    model = to_torch(params, cfg, device, train=True)
    state = torch.load(prefix + ".optim.pt", map_location="cpu",
                       weights_only=True)
    return model, state


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


def load_checkpoint(path, vocab_size=10000, seq_length=15):
    """An `.npz` checkpoint -> (params, meta, cfg).

    `meta` is the JSON under `__extra__/meta` ({} without one). The
    config is `meta["config"]` when present; otherwise the defaults with
    the vocabulary size and caption length of `meta`, or else of the
    arguments.
    """
    params, extra = load_params(path)
    meta = json.loads(str(extra["meta"])) if "meta" in extra else {}
    if "config" in meta:
        cfg = DenseCapConfig.from_json(meta["config"])
    else:
        cfg = DenseCapConfig(
            vocab_size=int(meta.get("vocab_size", vocab_size)),
            seq_length=int(meta.get("seq_length", seq_length)))
    return params, meta, cfg


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


def to_torch(params, cfg, device, train=False):
    """Numpy (or array-like) parameter tree -> `DenseCap` on `device`:
    an inference model in eval mode, or with `train=True` a training
    model of f32 masters in train mode."""
    cd = cfg.compute_dtype
    wd = torch.float32 if train else cd  # storage dtype of the weights

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def conv(p, bias_dtype):
        w = t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)), wd)
        return (w.contiguous(memory_format=torch.channels_last),
                t(p["b"], bias_dtype))

    def linear(p):
        return t(p["w"], wd), t(p["b"])

    def layer(p):
        """fc6, fc7 and the vocab projection: full precision or int8."""
        if not is_quantized(p):
            return Linear(*linear(p))
        if train:
            raise ValueError("a quantized params tree is inference-only: "
                             "to_torch(..., train=True) refuses it")
        return QuantLinear(p, device)

    def trunk(spec, tree):
        return Trunk(spec, {item[0]: conv(tree[item[0]], wd)
                            for item in spec if item != "M"}, cd)

    rp, lm = params["rpn"], params["lm"]
    model = DenseCap(
        cfg,
        trunk(TRUNK1_CFG, params["trunk1"]),
        trunk(TRUNK2_CFG, params["trunk2"]),
        RPN(conv(rp["conv"], torch.float32), conv(rp["box"], torch.float32),
            conv(rp["score"], torch.float32), cd),
        Recog(layer(params["recog"]["fc6"]), layer(params["recog"]["fc7"]),
              cd),
        linear(params["objectness"]),
        linear(params["box_reg"]),
        LanguageModel(*linear(lm["img_enc"]), t(lm["embed"]),
                      t(lm["lstm"]["Wx"], wd), t(lm["lstm"]["Wh"], wd),
                      t(lm["lstm"]["b"]), layer(lm["proj"]), cd),
    )
    if not train:
        return model.eval()
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith("trunk1."))
    return model.train()


def from_torch(model):
    """`DenseCap` -> numpy f32 tree with the JAX package's names and
    layouts (OIHW conv weights back to HWIO)."""
    def n(x):
        return x.detach().to(device="cpu", dtype=torch.float32).numpy()

    def conv(w, b):
        return {"w": np.ascontiguousarray(n(w).transpose(2, 3, 1, 0)),
                "b": n(b)}

    def trunk(tr):
        return {name: conv(tr.weights[name], tr.biases[name])
                for name in tr.weights}

    rpn, rec, lm = model.rpn, model.recog, model.lm
    return {
        "trunk1": trunk(model.trunk1),
        "trunk2": trunk(model.trunk2),
        "rpn": {"conv": conv(rpn.conv_w, rpn.conv_b),
                "box": conv(rpn.box_w, rpn.box_b),
                "score": conv(rpn.score_w, rpn.score_b)},
        "recog": {"fc6": {"w": n(rec.fc6.w), "b": n(rec.fc6.b)},
                  "fc7": {"w": n(rec.fc7.w), "b": n(rec.fc7.b)}},
        "objectness": {"w": n(model.obj_w), "b": n(model.obj_b)},
        "box_reg": {"w": n(model.box_w), "b": n(model.box_b)},
        "lm": {"img_enc": {"w": n(lm.enc_w), "b": n(lm.enc_b)},
               "embed": n(lm.embed_w),
               "lstm": {"Wx": n(lm.Wx), "Wh": n(lm.Wh), "b": n(lm.b)},
               "proj": {"w": n(lm.proj.w), "b": n(lm.proj.b)}},
    }
