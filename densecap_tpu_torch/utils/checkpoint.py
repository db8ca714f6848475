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
    gradients. A training model built inside a model group of M > 1
    (`parallel.distributed.initialize(model_parallel=M)`) is this rank's
    shard (`parallel.mesh.shard_params`): fc6, fc7 and the vocab
    projection keep its columns.
  * `from_torch(model)`: the reverse, a numpy tree with the JAX package's
    names and layouts (a sharded model's layers gathered to full width,
    a collective of its model group), and `save_params(path, tree,
    extra)`, which writes it as the `.npz` that the JAX `load_params`
    and `load_params` here read.
  * `convert_torch_densecap(weights)`, `convert_torch_vgg16(weights)`
    and `rename_torchvision_vgg16(state_dict)`: torch-layout weights (the
    reference's t7 read by `utils.t7_reader`, or a torchvision VGG-16)
    -> the numpy tree, twins of the JAX package's converters.
  * `save_train_state(prefix, trainer, it, meta)` /
    `load_train_state(prefix, cfg, device)`: a training run's pair,
    `<prefix>.npz` (the parameters as above) and `<prefix>.optim.pt`
    (`Trainer.state_dict()` and the iteration, `torch.save`), which the
    train CLI's `--checkpoint_start_from` resumes from. The pair is
    always the full model and the full Adam state (the projection V+1
    wide), so a run at any `--model_parallel` resumes one written at any
    other.

A tree that `ops.quant.quantize_for_inference` (or the JAX package's, as
numpy) has quantized builds an int8 inference model: each quantized layer
becomes a `QuantLinear` whose codes stay int8 and whose scales and bias
stay f32. `to_torch(..., train=True)` refuses such a tree, and
`from_torch` takes full-precision models only.

Layouts: JAX conv kernels are HWIO and become OIHW; linear weights stay
(in, out); the LSTM keeps torch-rnn's (i, f, o, g) gate order.
"""

from __future__ import annotations

import functools
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
from ..parallel import distributed
from ..parallel.mesh import param_shard_dims, shard_params
from ..parallel.tensor_parallel import ColumnShard


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


def gather_train_state(trainer):
    """(the full parameter tree, `trainer.state_dict()`): under tensor
    parallelism both gather over the model group, so every rank of it
    must call this."""
    return from_torch(trainer.model), trainer.state_dict()


def write_train_state(prefix, params, state, it, meta):
    """Write the pair from `gather_train_state`'s (params, state):
    `<prefix>.npz` (with `meta` under `__extra__/meta`) and
    `<prefix>.optim.pt` (`state` and `iter`)."""
    save_params(prefix + ".npz", params, extra={"meta": meta})
    torch.save(dict(state, iter=int(it)), prefix + ".optim.pt")


def save_train_state(prefix, trainer, it, meta):
    """Write a training run's pair: `<prefix>.npz` (the model, with
    `meta` under `__extra__/meta`) and `<prefix>.optim.pt`
    (`trainer.state_dict()` and `iter`). Under tensor parallelism every
    rank of the model group calls it and rank 0 writes."""
    params, state = gather_train_state(trainer)
    if distributed.is_main_process():
        write_train_state(prefix, params, state, it, meta)


def load_train_state(prefix, cfg, device):
    """Read the pair of `save_train_state` -> (model, state): the training
    model of `<prefix>.npz` built with `cfg` on `device` (inside a model
    group, this rank's shard of it; see `to_torch`), and the
    `.optim.pt` dict, whose "iter" is the saved iteration; the rest is for
    `Trainer.load_state_dict`, which also takes this rank's columns of
    the moments. The Adam state loads onto the CPU and
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
    model of f32 masters in train mode.

    A training model inside a model group of M > 1 keeps this rank's
    shard of the tree (`mesh.shard_params`, the leaves and dims of
    `mesh.param_shard_dims`): fc6, fc7 and the vocab projection become
    column-parallel `Linear`s over the group. The ranks of data index 0
    must pass the same tree (the same seed or file): `Trainer` then
    broadcasts each shard from there over its data group."""
    shards = {}  # layer path -> this rank's ColumnShard of it
    if train and distributed.model_size() > 1:
        for name, dim in param_shard_dims(params).items():
            if dim is not None and name.endswith("/w"):
                path = name[:-len("/w")]
                w = functools.reduce(lambda t, k: t[k], path.split("/"),
                                     params)["w"]
                shards[path] = ColumnShard.of_this_rank(np.shape(w)[dim])
        params = shard_params(params, distributed.model_rank(),
                              distributed.model_size())
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

    def layer(p, path):
        """fc6, fc7 and the vocab projection: full precision (or this
        rank's columns of it), or int8."""
        if not is_quantized(p):
            return Linear(*linear(p), shards.get(path))
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
        Recog(layer(params["recog"]["fc6"], "recog/fc6"),
              layer(params["recog"]["fc7"], "recog/fc7"), cd),
        linear(params["objectness"]),
        linear(params["box_reg"]),
        LanguageModel(*linear(lm["img_enc"]), t(lm["embed"]),
                      t(lm["lstm"]["Wx"], wd), t(lm["lstm"]["Wh"], wd),
                      t(lm["lstm"]["b"]), layer(lm["proj"], "lm/proj"), cd),
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

    def linear(layer):
        return dict(zip("wb", map(n, layer.full())))

    rpn, rec, lm = model.rpn, model.recog, model.lm
    return {
        "trunk1": trunk(model.trunk1),
        "trunk2": trunk(model.trunk2),
        "rpn": {"conv": conv(rpn.conv_w, rpn.conv_b),
                "box": conv(rpn.box_w, rpn.box_b),
                "score": conv(rpn.score_w, rpn.score_b)},
        "recog": {"fc6": linear(rec.fc6), "fc7": linear(rec.fc7)},
        "objectness": {"w": n(model.obj_w), "b": n(model.obj_b)},
        "box_reg": {"w": n(model.box_w), "b": n(model.box_b)},
        "lm": {"img_enc": {"w": n(lm.enc_w), "b": n(lm.enc_b)},
               "embed": n(lm.embed_w),
               "lstm": {"Wx": n(lm.Wx), "Wh": n(lm.Wh), "b": n(lm.b)},
               "proj": linear(lm.proj)},
    }


# ---------------------------------------------------------------------------
# Torch-layout weights (the reference's t7, loadcaffe or torchvision VGG-16)
# -> the numpy tree above. numpy only: the same arrays the JAX package's
# converters emit (HWIO convs, (in, out) linears), so the .npz serves both.
# ---------------------------------------------------------------------------

# our conv names in torch's 1-based Sequential order (loadcaffe VGG-16)
_VGG_CONV_ORDER = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
]

# torchvision vgg16 state_dict layer indices -> our names, so
# {k: v.numpy() for k, v in tv_state_dict.items()} renames straight
# into convert_torch_vgg16's expected keys
_TORCHVISION_VGG16 = {
    "features.0": "conv1_1", "features.2": "conv1_2",
    "features.5": "conv2_1", "features.7": "conv2_2",
    "features.10": "conv3_1", "features.12": "conv3_2",
    "features.14": "conv3_3",
    "features.17": "conv4_1", "features.19": "conv4_2",
    "features.21": "conv4_3",
    "features.24": "conv5_1", "features.26": "conv5_2",
    "features.28": "conv5_3",
    "classifier.0": "fc6", "classifier.3": "fc7",
}


def rename_torchvision_vgg16(state_dict):
    """torchvision vgg16 {features.N.weight: array} -> our naming.

    torchvision's VGG takes RGB images normalized to 0..1 and then by
    ImageNet's mean and std; the reference caffemodel, and this model,
    take BGR 0..255 pixels less the VGG mean. The renaming changes no
    value: a caller starting from torchvision's weights must reverse
    conv1_1's input channels and fold the normalization into it.
    """
    out = {}
    for key, arr in state_dict.items():
        base, _, kind = key.rpartition(".")
        if base in _TORCHVISION_VGG16 and kind in ("weight", "bias"):
            out[f"{_TORCHVISION_VGG16[base]}.{kind}"] = arr
    return out


def _conv_hwio(weights, name):
    w = weights[f"{name}.weight"]                       # (Cout, Cin, kh, kw)
    return {"w": np.transpose(w, (2, 3, 1, 0)).astype(np.float32).copy(),
            "b": weights[f"{name}.bias"].astype(np.float32)}


def _linear_t(weights, name):
    w = weights[f"{name}.weight"]                       # (out, in) torch
    return {"w": w.astype(np.float32).T.copy(),
            "b": weights[f"{name}.bias"].astype(np.float32)}


def convert_torch_vgg16(weights, out_hw=(7, 7)):
    """{name: np.ndarray} torch-layout VGG-16 -> our trunk/recog trees.

    Expected keys: '<conv_name>.weight' (Cout, Cin, kh, kw) and '.bias';
    'fc6.weight' (4096, 25088), 'fc6.bias', 'fc7.weight' (4096, 4096),
    'fc7.bias'. Returns (trunk1, trunk2, recog) param dicts.

    fc6's input flatten order is torch channel-major (C, H, W); our RoI
    features flatten NHWC (H, W, C) — the weight's input dim is permuted
    accordingly.
    """
    trunk1 = {n: _conv_hwio(weights, n) for n in _VGG_CONV_ORDER[:4]}
    trunk2 = {n: _conv_hwio(weights, n) for n in _VGG_CONV_ORDER[4:]}

    H, W = out_hw
    C = weights["fc6.weight"].shape[1] // (H * W)
    w6 = weights["fc6.weight"].astype(np.float32)       # (4096, C*H*W)
    # torch input index = c*H*W + y*W + x; ours = y*W*C + x*C + c
    w6 = w6.reshape(-1, C, H, W).transpose(0, 2, 3, 1).reshape(w6.shape[0], -1)
    recog = {
        "fc6": {"w": w6.T.copy(), "b": weights["fc6.bias"].astype(np.float32)},
        "fc7": _linear_t(weights, "fc7"),
    }
    return trunk1, trunk2, recog


def convert_torch_densecap(weights, out_hw=(7, 7)):
    """Full torch-layout DenseCap weights -> complete params tree.

    Input is the flat dict from t7_reader.extract_full_densecap_weights
    (VGG names + rpn_conv/rpn_box/rpn_score, objectness, box_reg,
    lm_image_encoder, lm_lookup, lm_lstm, lm_proj). Returns
    (params, info) where params has the tree of `init_params` and
    info carries dimensions derived from the tensors themselves
    (vocab_size, num_anchors, rnn sizes) for config validation.

    Layout mapping per tensor:
      * convs: torch (Cout, Cin, kh, kw) -> HWIO (identical channel
        semantics: both frameworks group the box/score head channels as
        (anchor, dim) — ReshapeBoxFeatures.lua:30 `view(N, k, D, H, W)`
        vs ops/transforms.reshape_box_features).
      * Linears: torch (out, in) -> ours (in, out) transpose.
      * LookupTable: (V+2, W) copied as-is (row token-1 indexing both).
      * torch-rnn nn.LSTM: one fused (D+H, 4H) weight, gate order
        (i, f, o, g); rows 0..D-1 are Wx, rows D.. are Wh — our cell
        keeps the same gate order (`models/lstm.py` `lstm_step`), so the
        split is a plain row slice.
    """
    trunk1, trunk2, recog = convert_torch_vgg16(weights, out_hw=out_hw)

    rpn = {"conv": _conv_hwio(weights, "rpn_conv"),
           "box": _conv_hwio(weights, "rpn_box"),
           "score": _conv_hwio(weights, "rpn_score")}

    enc_w = weights["lm_image_encoder.weight"]          # (W, D)
    W_enc = enc_w.shape[0]
    lstm_w = weights["lm_lstm.weight"].astype(np.float32)   # (D+H, 4H)
    H_rnn = lstm_w.shape[1] // 4
    lm = {
        "img_enc": _linear_t(weights, "lm_image_encoder"),
        "embed": weights["lm_lookup.weight"].astype(np.float32).copy(),
        "lstm": {"Wx": lstm_w[:W_enc].copy(),
                 "Wh": lstm_w[W_enc:].copy(),
                 "b": weights["lm_lstm.bias"].astype(np.float32)},
        "proj": _linear_t(weights, "lm_proj"),
    }

    params = {
        "trunk1": trunk1,
        "trunk2": trunk2,
        "rpn": rpn,
        "recog": recog,
        "objectness": _linear_t(weights, "objectness"),
        "box_reg": _linear_t(weights, "box_reg"),
        "lm": lm,
    }
    info = {
        "vocab_size": int(weights["lm_lookup.weight"].shape[0] - 2),
        "num_anchors": int(weights["rpn_box.weight"].shape[0] // 4),
        "rpn_num_filters": int(weights["rpn_conv.weight"].shape[0]),
        "rnn_size": int(H_rnn),
        "rnn_encoding_size": int(W_enc),
        "fc_dim": int(weights["fc7.weight"].shape[0]),
    }
    return params, info
