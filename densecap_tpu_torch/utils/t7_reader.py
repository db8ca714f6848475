"""Minimal pure-python reader for Torch7 serialization (.t7 files).

The port's own copy of `densecap_tpu/utils/t7_reader.py` (numpy only; the
port imports nothing of the JAX package). It reads the binary
DEFAULT-mode format torch.save produces (typed objects, memoized
tables, torch.*Tensor / torch.*Storage payloads) into plain python
dicts, lists and numpy arrays, for checkpoint conversion only
(`cli/convert_t7.py`). nn modules and other torch classes come back as
`TorchObject` wrappers around their field table, which is all the
weight extractors need.

Format (little-endian):
  object   := int32 type, payload
  NIL(0)          -> None
  NUMBER(1)       -> float64 (an integral value becomes an int)
  STRING(2)       -> int32 len + bytes
  TABLE(3)        -> int32 memo-index, int32 n, n x (key obj, value obj);
                     keys 1..n become a python list
  TORCH(4)        -> int32 memo-index, version string ("V <n>") or class
                     name directly (legacy), class name string, payload:
                       *Tensor  -> int32 ndim, ndim x int64 sizes,
                                   ndim x int64 strides,
                                   int64 storageOffset (1-based),
                                   object (the storage)
                       *Storage -> int64 size, size x element
                       other    -> one object (the field table)
  BOOLEAN(5)      -> int32 0/1
  FUNCTION(6/7/8) -> unsupported (raises)

A memo index seen again returns the object read the first time, so two
references share one python object.
"""

from __future__ import annotations

import struct

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.IntStorage": np.int32,
    "torch.LongStorage": np.int64,
    "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
    "torch.ShortStorage": np.int16,
}
_TENSOR_CLASSES = {
    "torch.FloatTensor", "torch.DoubleTensor", "torch.IntTensor",
    "torch.LongTensor", "torch.ByteTensor", "torch.CharTensor",
    "torch.ShortTensor", "torch.CudaTensor",
}


class TorchObject:
    """A deserialized torch class instance: class name + field table."""

    def __init__(self, torch_class, fields):
        self.torch_class = torch_class
        self.fields = fields or {}

    def __getitem__(self, key):
        return self.fields[key]

    def get(self, key, default=None):
        return self.fields.get(key, default)

    def __contains__(self, key):
        return key in self.fields

    def __repr__(self):
        return f"TorchObject({self.torch_class}, {list(self.fields)[:8]})"


class T7Reader:
    def __init__(self, f):
        self.f = f
        self.memo = {}

    def _read(self, fmt, size):
        data = self.f.read(size)
        if len(data) != size:
            raise EOFError("truncated t7 file")
        return struct.unpack("<" + fmt, data)[0]

    def read_int(self):
        return self._read("i", 4)

    def read_long(self):
        return self._read("q", 8)

    def read_double(self):
        return self._read("d", 8)

    def read_string(self):
        n = self.read_int()
        return self.f.read(n).decode("utf-8", errors="replace")

    def read_object(self):
        typ = self.read_int()
        if typ == TYPE_NIL:
            return None
        if typ == TYPE_NUMBER:
            v = self.read_double()
            return int(v) if v.is_integer() else v
        if typ == TYPE_STRING:
            return self.read_string()
        if typ == TYPE_BOOLEAN:
            return self.read_int() == 1
        if typ == TYPE_TABLE:
            return self._read_table()
        if typ == TYPE_TORCH:
            return self._read_torch()
        if typ in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            raise NotImplementedError(
                "t7 contains a serialized function; not supported"
            )
        raise ValueError(f"unknown t7 type code {typ}")

    def _read_table(self):
        idx = self.read_int()
        if idx in self.memo:
            return self.memo[idx]
        out = {}
        self.memo[idx] = out
        n = self.read_int()
        for _ in range(n):
            k = self.read_object()
            v = self.read_object()
            out[k] = v
        # lua arrays: 1..n integer keys -> python list
        if out and all(isinstance(k, int) for k in out):
            keys = sorted(out)
            if keys == list(range(1, len(keys) + 1)):
                lst = [out[k] for k in keys]
                self.memo[idx] = lst
                return lst
        return out

    def _read_torch(self):
        idx = self.read_int()
        if idx in self.memo:
            return self.memo[idx]
        version = self.read_string()
        if version.startswith("V "):
            cls = self.read_string()
        else:
            cls = version  # legacy: no version string

        if cls in _TENSOR_CLASSES:
            obj = self._read_tensor(cls)
            self.memo[idx] = obj
            return obj
        if cls in _STORAGE_DTYPES:
            obj = self._read_storage(cls)
            self.memo[idx] = obj
            return obj
        # generic torch class: payload is its field table
        placeholder = TorchObject(cls, {})
        self.memo[idx] = placeholder
        fields = self.read_object()
        if isinstance(fields, dict):
            placeholder.fields = fields
        elif isinstance(fields, list):
            placeholder.fields = {i + 1: v for i, v in enumerate(fields)}
        elif fields is not None:
            placeholder.fields = {"value": fields}
        return placeholder

    def _read_tensor(self, cls):
        ndim = self.read_int()
        sizes = [self.read_long() for _ in range(ndim)]
        strides = [self.read_long() for _ in range(ndim)]
        offset = self.read_long() - 1  # 1-based
        storage = self.read_object()
        if ndim == 0 or storage is None:
            return np.zeros(sizes or (0,), np.float32)
        flat = np.asarray(storage)
        return np.lib.stride_tricks.as_strided(
            flat[offset:],
            shape=sizes,
            strides=[s * flat.itemsize for s in strides],
        ).copy()

    def _read_storage(self, cls):
        dtype = np.dtype(_STORAGE_DTYPES[cls])
        n = self.read_long()
        data = self.f.read(n * dtype.itemsize)
        if len(data) != n * dtype.itemsize:
            raise EOFError("truncated t7 file (storage payload cut short)")
        return np.frombuffer(data, dtype=dtype).copy()


def load(path):
    """Read one object from a .t7 file (DEFAULT binary format)."""
    with open(path, "rb") as f:
        return T7Reader(f).read_object()


# ---------------------------------------------------------------------------
# DenseCap checkpoint weight extraction
# ---------------------------------------------------------------------------

def _iter_modules(obj, seen=None):
    """Depth-first walk yielding every TorchObject (nn modules etc)."""
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, TorchObject):
        yield obj
        for v in obj.fields.values():
            yield from _iter_modules(v, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_modules(v, seen)
    elif isinstance(obj, list):
        for v in obj:
            yield from _iter_modules(v, seen)


def _sequential_convs_linears(seq):
    """conv/linear (weight, bias) pairs from an nn.Sequential, in order."""
    out = []
    for m in seq.get("modules", []):
        cls = getattr(m, "torch_class", "")
        if "SpatialConvolution" in cls:
            out.append((_conv_weight_4d(m), np.asarray(m["bias"])))
        elif cls.endswith("Linear"):
            out.append((np.asarray(m["weight"]), np.asarray(m["bias"])))
        elif isinstance(m, TorchObject) and "modules" in m:
            out.extend(_sequential_convs_linears(m))
    return out


def _model_nets(checkpoint):
    model = checkpoint
    if isinstance(checkpoint, dict) and "model" in checkpoint:
        model = checkpoint["model"]
    nets = model.get("nets") if isinstance(model, TorchObject) else None
    if nets is None:
        raise ValueError("could not find model.nets in the checkpoint")
    return nets


def _conv_weight_4d(module):
    """Return a conv module's weight as (Cout, Cin, kh, kw).

    nn.SpatialConvolutionMM (and de-cudnnified convs in some torch
    versions) store the weight flattened as (Cout, Cin*kh*kw); the
    module's kW/kH/nInputPlane fields recover the 4-d shape.
    """
    w = np.asarray(module["weight"])
    if w.ndim == 4:
        return w
    if w.ndim == 2:
        kw = int(module.get("kW", 0))
        kh = int(module.get("kH", 0))
        cin = int(module.get("nInputPlane", 0))
        if kw and kh and cin and w.shape[1] == cin * kh * kw:
            return w.reshape(w.shape[0], cin, kh, kw)
    raise ValueError(f"cannot interpret conv weight of shape {w.shape}")


def extract_densecap_weights(checkpoint):
    """Best-effort extraction of VGG weights from a loaded DenseCap t7.

    Accepts the torch.load()'d checkpoint (usually {model=..., ...} or
    the model object itself); returns the {name: array} dict expected by
    checkpoint.convert_torch_vgg16. Layer identification follows
    DenseCapModel.lua:61-67: conv_net1 = conv1_1..conv2_2 (4 convs),
    conv_net2 = conv3_1..conv5_3 (9 convs), recog_base = fc6, fc7.
    """
    nets = _model_nets(checkpoint)

    conv1 = _sequential_convs_linears(nets["conv_net1"])
    conv2 = _sequential_convs_linears(nets["conv_net2"])
    recog = _sequential_convs_linears(nets["recog_base"])
    if len(conv1) != 4 or len(conv2) != 9 or len(recog) != 2:
        raise ValueError(
            f"unexpected layer counts: conv1={len(conv1)} "
            f"conv2={len(conv2)} recog={len(recog)}"
        )
    names = [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2",
        "conv3_1", "conv3_2", "conv3_3",
        "conv4_1", "conv4_2", "conv4_3",
        "conv5_1", "conv5_2", "conv5_3",
        "fc6", "fc7",
    ]
    weights = {}
    for name, (w, b) in zip(names, conv1 + conv2 + recog):
        # a Linear is (out, in), a conv (out, in, kh, kw)
        if w.ndim not in (2, 4):
            raise ValueError(f"{name}: unexpected weight ndim {w.ndim}")
        weights[f"{name}.weight"] = w
        weights[f"{name}.bias"] = b
    return weights


def _find_modules(obj, predicate):
    return [m for m in _iter_modules(obj) if predicate(m)]


def extract_full_densecap_weights(checkpoint):
    """Extract EVERY learned tensor from a loaded DenseCap t7 checkpoint.

    Unlike extract_densecap_weights (VGG trunk/FC only), this also maps:

      * the RPN conv stack (LocalizationLayer.lua:609-690): the 3x3
        conv(512->rpn_num_filters), the 1x1 box head (4k channels) and
        the 1x1 score head (2k channels), found inside
        model.nets.localization_layer.nets.rpn in depth-first order
        (conv, box_branch conv, rpn_branch conv);
      * the final objectness/box-reg Linears (DenseCapModel.lua:93-100);
      * the whole LanguageModel (LanguageModel.lua:27-61): image_encoder
        Linear(4096->512), LookupTable(V+2, W), the torch-rnn nn.LSTM
        (one fused weight (D+H, 4H) + bias, gate order i,f,o,g) and the
        output projection Linear(H -> V+1).

    Returns a flat {name: torch-layout array} dict (see the key list in
    checkpoint.convert_torch_densecap, which consumes it).
    """
    weights = dict(extract_densecap_weights(checkpoint))
    nets = _model_nets(checkpoint)

    # --- RPN (3 convs, depth-first: 3x3 trunk conv, box head, score head)
    loc = nets["localization_layer"]
    rpn_seq = loc["nets"]["rpn"]
    rpn_convs = _find_modules(
        rpn_seq, lambda m: "SpatialConvolution" in m.torch_class)
    if len(rpn_convs) != 3:
        raise ValueError(f"expected 3 RPN convs, found {len(rpn_convs)}")
    conv_w = _conv_weight_4d(rpn_convs[0])
    box_w = _conv_weight_4d(rpn_convs[1])
    score_w = _conv_weight_4d(rpn_convs[2])
    nf = conv_w.shape[0]
    if conv_w.shape[2:] != (3, 3):
        raise ValueError(f"RPN conv kernel {conv_w.shape} is not 3x3")
    if box_w.shape[0] % 4 or box_w.shape[1] != nf:
        raise ValueError(f"RPN box head shape {box_w.shape} unexpected")
    if score_w.shape[0] % 2 or score_w.shape[1] != nf:
        raise ValueError(f"RPN score head shape {score_w.shape} unexpected")
    if box_w.shape[0] // 4 != score_w.shape[0] // 2:
        raise ValueError("box/score heads disagree on anchor count")
    weights["rpn_conv.weight"] = conv_w
    weights["rpn_conv.bias"] = np.asarray(rpn_convs[0]["bias"])
    weights["rpn_box.weight"] = box_w
    weights["rpn_box.bias"] = np.asarray(rpn_convs[1]["bias"])
    weights["rpn_score.weight"] = score_w
    weights["rpn_score.bias"] = np.asarray(rpn_convs[2]["bias"])

    # --- final branches (DenseCapModel.lua:93-100)
    for key, net_name, out_dim in (("objectness", "objectness_branch", 1),
                                   ("box_reg", "box_reg_branch", 4)):
        mod = nets[net_name]
        w = np.asarray(mod["weight"])
        if w.ndim != 2 or w.shape[0] != out_dim:
            raise ValueError(f"{net_name}: weight shape {w.shape}")
        weights[f"{key}.weight"] = w
        weights[f"{key}.bias"] = np.asarray(mod["bias"])

    # --- language model (LanguageModel.lua:27-61)
    lm = nets["language_model"]
    enc_linears = _find_modules(
        lm["image_encoder"], lambda m: m.torch_class.endswith("Linear"))
    if len(enc_linears) != 1:
        raise ValueError("expected exactly one image_encoder Linear")
    weights["lm_image_encoder.weight"] = np.asarray(enc_linears[0]["weight"])
    weights["lm_image_encoder.bias"] = np.asarray(enc_linears[0]["bias"])

    lookup = lm["lookup_table"]
    weights["lm_lookup.weight"] = np.asarray(lookup["weight"])  # (V+2, W)

    lstms = _find_modules(lm["rnn"], lambda m: m.torch_class.endswith("LSTM"))
    projs = _find_modules(
        lm["rnn"], lambda m: m.torch_class.endswith("Linear"))
    if len(lstms) != 1 or len(projs) != 1:
        raise ValueError(
            f"expected 1 LSTM + 1 Linear in lm.rnn, "
            f"found {len(lstms)}/{len(projs)} (num_layers>1 unsupported)")
    lw = np.asarray(lstms[0]["weight"])   # (D+H, 4H) torch-rnn fused
    lb = np.asarray(lstms[0]["bias"])     # (4H,)
    pw = np.asarray(projs[0]["weight"])   # (V+1, H)
    W_enc = weights["lm_image_encoder.weight"].shape[0]
    H_rnn = lw.shape[1] // 4
    if lw.shape[0] != W_enc + H_rnn:
        raise ValueError(
            f"LSTM weight shape {lw.shape} inconsistent with "
            f"input_encoding_size={W_enc}")
    V_plus_2 = weights["lm_lookup.weight"].shape[0]
    if pw.shape != (V_plus_2 - 1, H_rnn):
        raise ValueError(f"projection shape {pw.shape}, expected "
                         f"({V_plus_2 - 1}, {H_rnn})")
    weights["lm_lstm.weight"] = lw
    weights["lm_lstm.bias"] = lb
    weights["lm_proj.weight"] = pw
    weights["lm_proj.bias"] = np.asarray(projs[0]["bias"])
    return weights


def extract_idx_to_token(checkpoint):
    """The vocabulary stored inside the checkpoint's LanguageModel
    (LanguageModel.lua:20 keeps opt.idx_to_token on the module), as
    {int: str}. Returns {} if absent."""
    nets = _model_nets(checkpoint)
    lm = nets.get("language_model") if isinstance(nets, dict) else None
    if lm is None:
        return {}
    mapping = lm.get("idx_to_token")
    if isinstance(mapping, list):
        # a contiguous 1..V lua table deserializes as a python list
        return {i + 1: str(v) for i, v in enumerate(mapping)}
    if not isinstance(mapping, dict):
        return {}
    out = {}
    for k, v in mapping.items():
        try:
            out[int(k)] = str(v)
        except (TypeError, ValueError):
            continue
    return out
