"""The port's t7 path (`utils/t7_reader.py`, the torch-layout converters of
`utils/checkpoint.py`, `cli/convert_t7.py`) against the JAX package's.

  * the reader: the same objects as JAX's reader (classes, fields, arrays
    bit-equal, shared references kept shared) on every hand-encoded blob
    of `tests/test_t7_bytes_golden.py` and on the synthetic DenseCap t7s
    of `tests/test_t7_reader.py` / `tests/test_full_convert.py`; the
    weight extractors' dicts bit-equal;
  * the converters: `convert_torch_densecap`, `convert_torch_vgg16` and
    `rename_torchvision_vgg16` bit-equal;
  * both `convert_t7` CLIs: the same `.npz` keys, every array bit-equal,
    the same vocabulary; with `--vgg_only` the VGG arrays bit-equal and
    the fresh heads equal in shape;
  * the port's `.npz` read back by the port's `load_checkpoint` and by
    JAX's `load_params` + `DenseCapConfig.from_json`;
  * the converted model's `forward_test_batch` against JAX's on the same
    frames (f32): captions and validity equal, boxes and scores within
    1e-4.
"""

import inspect
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_full_convert as tfc
import test_t7_bytes_golden as golden
from densecap_tpu.cli import convert_t7 as jax_convert
from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.utils import checkpoint as jax_ckpt
from densecap_tpu.utils import t7_reader as jt7
from densecap_tpu_torch.cli import convert_t7
from densecap_tpu_torch.utils import checkpoint as ckpt
from densecap_tpu_torch.utils import t7_reader as pt7
from densecap_tpu_torch.utils.image import to_model_input
from test_t7_reader import _mini_densecap_t7, _Writer

torch.set_num_threads(2)
GOLDEN = sorted(name for name, fn in inspect.getmembers(golden,
                                                        inspect.isfunction)
                if name.startswith("test_"))


def assert_same(a, b, seen=None):
    """JAX-reader object `a` and port-reader object `b` are the same:
    equal classes, fields, values and arrays (dtype and bits), and a
    container shared in `a` is shared in `b`."""
    seen = {} if seen is None else seen
    if isinstance(a, (jt7.TorchObject, dict, list, np.ndarray)):
        if id(a) in seen:
            assert seen[id(a)] is b
            return
        seen[id(a)] = b
    if isinstance(a, jt7.TorchObject):
        assert isinstance(b, pt7.TorchObject)
        assert a.torch_class == b.torch_class
        assert_same(a.fields, b.fields, seen)
    elif isinstance(a, dict):
        assert type(b) is dict and list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k], seen)
    elif isinstance(a, (list, tuple)):
        assert type(b) is type(a) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y, seen)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, strict=True)
    else:
        assert type(a) is type(b) and a == b


def _both(blob):
    a = jt7.T7Reader(io.BytesIO(blob)).read_object()
    b = pt7.T7Reader(io.BytesIO(blob)).read_object()
    assert_same(a, b)
    return a


@pytest.mark.parametrize("name", GOLDEN)
def test_reader_matches_jax_on_golden_blobs(name, monkeypatch):
    """Each golden test, its blobs read by both readers (the test's own
    assertions then run on the JAX reader's object)."""
    blobs = []

    def read(blob):
        blobs.append(blob)
        return _both(blob)

    monkeypatch.setattr(golden, "_read", read)
    getattr(golden, name)()
    assert blobs


def _blob(obj):
    w = _Writer()
    w.write(obj)
    return w.getvalue()


def _tame(obj):
    """Scale every weight of a synthetic t7 by 1 / sqrt(its fan-in), so
    13 convs of unit-normal weights keep finite activations."""
    for m in jt7._iter_modules(obj):
        w = m.fields.get("weight")
        if isinstance(w, np.ndarray):
            m.fields["weight"] = (w / np.sqrt(np.prod(w.shape[1:]))
                                  ).astype(np.float32)
    return obj


@pytest.fixture
def full_t7(monkeypatch):
    """The full synthetic DenseCap t7 at the shipping anchor count (the
    CLIs refuse another)."""
    monkeypatch.setattr(tfc, "K", 12)
    return _tame(tfc._full_densecap_t7(np.random.RandomState(7)))


@pytest.mark.parametrize("which", ["mini", "full"])
def test_reader_and_extractors_match_jax(which, full_t7):
    obj = _mini_densecap_t7() if which == "mini" else full_t7
    blob = _blob(obj)
    a = jt7.T7Reader(io.BytesIO(blob)).read_object()
    b = pt7.T7Reader(io.BytesIO(blob)).read_object()
    assert_same(a, b)
    extractors = ["extract_densecap_weights", "extract_idx_to_token"]
    if which == "full":
        extractors.append("extract_full_densecap_weights")
    for name in extractors:
        assert_same(getattr(jt7, name)(a), getattr(pt7, name)(b))


def test_converters_match_jax(full_t7):
    weights = pt7.extract_full_densecap_weights(pt7.T7Reader(
        io.BytesIO(_blob(full_t7))).read_object())
    ref, ref_info = jax_ckpt.convert_torch_densecap(weights)
    got, got_info = ckpt.convert_torch_densecap(weights)
    assert got_info == ref_info
    assert_same(ref, got)
    assert_same(jax_ckpt.convert_torch_vgg16(weights),
                ckpt.convert_torch_vgg16(weights))
    tv = {f"{base}.{kind}": np.full(2, i, np.float32)
          for i, base in enumerate(["features.0", "features.28",
                                    "classifier.3", "features.1"])
          for kind in ("weight", "bias", "running_mean")}
    assert_same(jax_ckpt.rename_torchvision_vgg16(tv),
                ckpt.rename_torchvision_vgg16(tv))


def _convert_both(tmp_path, obj, extra=()):
    t7 = tmp_path / "ck.t7"
    t7.write_bytes(_blob(obj))
    out = {}
    for tag, cli in (("jax", jax_convert), ("port", convert_t7)):
        out[tag] = tmp_path / f"{tag}.npz"
        cli.main(["--t7", str(t7), "--output", str(out[tag]), *extra])
    with np.load(out["jax"]) as a, np.load(out["port"]) as b:
        arrays = ({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    return out, arrays


def test_convert_cli_matches_jax(tmp_path, full_t7):
    out, (ref, got) = _convert_both(tmp_path, full_t7)
    assert ref.keys() == got.keys()
    for k in ref:
        if k != "__extra__/meta":
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], strict=True)
    ref_meta = json.loads(str(ref["__extra__/meta"]))
    got_meta = json.loads(str(got["__extra__/meta"]))
    assert got_meta.keys() == ref_meta.keys()
    for k in ("vocab_size", "seq_length", "idx_to_token", "note"):
        assert got_meta[k] == ref_meta[k]
    assert len(got_meta["idx_to_token"]) == tfc.VOCAB

    # both packages read the port's file, to the same config
    params, meta, cfg = ckpt.load_checkpoint(str(out["port"]))
    jparams, extra = jax_ckpt.load_params(str(out["port"]))
    jcfg = JaxConfig.from_json(json.loads(str(extra["meta"]))["config"])
    assert meta["idx_to_token"] == ref_meta["idx_to_token"]
    for f in ("vocab_size", "seq_length", "rpn_num_filters", "rnn_size",
              "rnn_encoding_size", "fc_dim", "anchor_scale", "anchors"):
        assert getattr(cfg, f) == getattr(jcfg, f) == getattr(
            JaxConfig.from_json(ref_meta["config"]), f)
    assert_same(jparams, params)


def test_convert_cli_vgg_only_matches_jax(tmp_path, full_t7):
    _, (ref, got) = _convert_both(tmp_path, full_t7,
                                  ["--vgg_only", "--vocab_size", "23"])
    assert ref.keys() == got.keys()
    vgg = [k for k in ref if k.split("/")[0] in ("trunk1", "trunk2",
                                                 "recog")]
    assert len(vgg) == 30
    for k in ref:
        assert got[k].shape == ref[k].shape
        if k in vgg:
            np.testing.assert_array_equal(got[k], ref[k], strict=True)
    meta = json.loads(str(got["__extra__/meta"]))
    assert meta["idx_to_token"] == {} and meta["vocab_size"] == 23


def test_converted_model_matches_jax_forward(tmp_path, full_t7):
    t7 = tmp_path / "ck.t7"
    t7.write_bytes(_blob(full_t7))
    convert_t7.main(["--t7", str(t7), "--output", str(tmp_path / "p.npz")])
    params, _, cfg = ckpt.load_checkpoint(str(tmp_path / "p.npz"))
    cfg = cfg.replace(image_size=96, test_max_proposals=12,
                      test_pre_nms_topk=200, compute_dtype=torch.float32)
    jcfg = JaxConfig.from_json(cfg.to_json())
    rng = np.random.default_rng(1)
    canvases = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    x, h, w = to_model_input(canvases, [96.0, 72.0], [80.0, 96.0], "cpu")
    model = ckpt.to_torch(params, cfg, "cpu")
    got = model.forward_test_batch(x, h, w)
    ref = jax.jit(lambda p, a, b, c: jd.forward_test_batch(p, a, b, c, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x.numpy()),
        jnp.asarray(h.numpy()), jnp.asarray(w.numpy()))
    valid = np.asarray(ref.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.captions.numpy()[valid],
                                  np.asarray(ref.captions)[valid])
    for k in ("boxes", "scores"):
        a, b = getattr(got, k).numpy()[valid], np.asarray(getattr(ref, k))[
            valid]
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
