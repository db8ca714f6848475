"""The ViTDet trunk of the port (`models/vitdet.py`) at a tiny size on the
CPU, held to the benchmark's plain reference
(`benchmark/reference/vitdet_ref.py`, loaded from its path): a ViT of
width 64, 4 heads, depth 4 with global blocks {1, 3} and windows of 3 on
an 8 x 8 patch grid, so that the windowed blocks pad 8 to 9, with
relative-position tables, biases and LayerNorms all off their init.

  * the trunk and neck against the reference in f32 to 1e-5, and in bf16
    within 1.5e-2 (bf16 operands through four blocks read ~4e-3 here);
    frames smaller than their canvas, a canvas smaller than the ViT's
    input square, and a bucket's crop of a canvas;
  * the reference without the relative-position terms fails the f32
    tolerance, and the program without them fails it against the
    reference;
  * `forward_test_batch` against the reference's whole forward in f32:
    the RPN's picks, the final picks and the greedy tokens identical;
    beam search, `extract_features` and the serving engine run;
  * a checkpoint round trip and `cli/run_model.py` on a tiny ViTDet
    checkpoint;
  * the refusals: training (`to_torch(..., train=True)`, `Trainer`, the
    train CLI resuming a ViTDet pair), `--quantize` and
    `--model_parallel`;
  * a recorded forward's spans under `trunk`, their counts a call, and
    the counters;
  * a VGG-16 config's JSON as before, which the JAX package reads.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from densecap_tpu_torch.cli import run_model
from densecap_tpu_torch.cli._common import maybe_quantize
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.models.localization import localize_test
from densecap_tpu_torch.models.vitdet import VIT_TRAINING
from densecap_tpu_torch.parallel import distributed
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.utils import checkpoint as ckpt
from densecap_tpu_torch.utils import profiling as prof
from test_torch_train_cli import _args, dataset  # noqa: F401

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_TOL = 1.5e-2


def _reference_module():
    """`benchmark/reference/vitdet_ref.py` by its path (its package, for
    its relative import of `densecap_ref`)."""
    name = "bench_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, BENCH / "reference" / "__init__.py",
            submodule_search_locations=[str(BENCH / "reference")])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(name + ".vitdet_ref")


def tiny(dtype=torch.float32, **kw):
    return DenseCapConfig(
        trunk="vitdet_b", vocab_size=20, fc_dim=32, rnn_size=16,
        rnn_encoding_size=16, image_size=128, vit_img_size=128,
        vit_embed_dim=64, vit_num_heads=4, vit_depth=4,
        vit_global_blocks=(1, 3), vit_window_size=3, vit_pretrain_grid=4,
        vit_out_channels=32, rpn_num_filters=16, test_max_proposals=20,
        test_pre_nms_topk=100, compute_dtype=dtype, **kw)


@pytest.fixture(scope="module")
def params():
    """init_params' tree with every trunk bias and LayerNorm moved off
    its init (so the padded tokens' keys and values are the qkv bias)."""
    rng = np.random.default_rng(1)
    flat = ckpt._flatten(ckpt.init_params(tiny(), seed=0))
    for k, v in flat.items():
        if k.startswith("vit/") and (k.endswith("/b") or "norm" in k
                                     or "/ln" in k):
            flat[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return ckpt._unflatten(flat)


def reference(params):
    tree = ckpt._unflatten({k: torch.from_numpy(np.array(v))
                            for k, v in ckpt._flatten(params).items()})
    cfg = dataclasses.asdict(tiny())
    del cfg["compute_dtype"]
    return _reference_module().VitReference(tree, cfg)


def without_relative_positions(params):
    """The tree with every relative-position table zero."""
    return ckpt._unflatten({
        k: np.zeros_like(v) if "/rel_pos_" in k else v
        for k, v in ckpt._flatten(params).items()})


def images(B=2, H=128, W=112, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, 3), generator=g) * 30
    h, w = torch.tensor([128.0, 100.0])[:B], torch.tensor([112.0, 90.0])[:B]
    for b in range(B):
        x[b, int(h[b]):] = 0
        x[b, :, int(w[b]):] = 0
    return x, h, w


def rel(a, b):
    return float((a - b).norm() / b.norm())


@torch.no_grad()
def ref_features(ref, x, h, w):
    return [ref.features(x[b], h[b], w[b]) for b in range(x.shape[0])]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_trunk_matches_reference(params, dtype, tol):
    x, h, w = images()
    want = ref_features(reference(params), x, h, w)
    model = ckpt.to_torch(params, tiny(dtype), CPU)
    with torch.no_grad():
        got = model.features(x, h, w)
    assert got.shape == (2, 32, 8, 8)
    assert got.is_contiguous(memory_format=torch.channels_last)
    for b in range(2):
        assert rel(got[b], want[b]) < tol


def test_smaller_canvas_and_bucket_crop(params):
    """A canvas under the ViT's 128 px square is padded to it: a 96 x 80
    canvas, and the same frames on the 128 x 112 canvas cropped to it,
    give the features of the full canvas."""
    x, h, w = images()
    h, w = torch.tensor([96.0, 70.0]), torch.tensor([80.0, 64.0])
    for b in range(2):
        x[b, int(h[b]):] = 0
        x[b, :, int(w[b]):] = 0
    model = ckpt.to_torch(params, tiny(), CPU)
    with torch.no_grad():
        full = model.features(x, h, w)
        crop = model.features(x[:, :96, :80].contiguous(), h, w)
    assert torch.equal(full, crop)
    want = ref_features(reference(params), x[:, :96, :80], h, w)
    for b in range(2):
        assert rel(full[b], want[b]) < F32_TOL
    with pytest.raises(ValueError, match="at most 128x128"):
        model.features(torch.zeros(1, 144, 64, 3), h[:1], w[:1])


def test_relative_positions_are_seen(params):
    """Without the relative-position terms (the tables zero), the
    reference and the program both miss the f32 tolerance."""
    x, h, w = images()
    want = ref_features(reference(params), x, h, w)
    bare_params = without_relative_positions(params)
    bare = ref_features(reference(bare_params), x, h, w)
    model = ckpt.to_torch(bare_params, tiny(), CPU)
    with torch.no_grad():
        got = model.features(x, h, w)
    for b in range(2):
        assert rel(bare[b], want[b]) > 10 * F32_TOL
        assert rel(got[b], want[b]) > 10 * F32_TOL
        assert rel(got[b], bare[b]) < F32_TOL


def test_forward_test_batch_matches_reference(params):
    cfg = tiny()
    x, h, w = images()
    ref = reference(params)
    model = ckpt.to_torch(params, cfg, CPU)
    with torch.no_grad():
        out = model.forward_test_batch(x, h, w)
        loc = localize_test(model.rpn, model.features(x, h, w), h, w, cfg,
                            cfg.anchor_tensor(CPU),
                            extent=model.feat_extent(h, w))
        want = [ref.forward_test(x[b], h[b], w[b]) for b in range(2)]
    for b, r in enumerate(want):
        assert torch.equal(loc.roi_valid[b], r["roi_valid"])
        n = int(r["roi_valid"].sum())
        assert n > 0
        torch.testing.assert_close(loc.roi_boxes[b, :n], r["rois"][:n],
                                   rtol=0, atol=1e-4)
        k = int(r["valid"].sum())
        assert int(out.num[b]) == k > 0
        torch.testing.assert_close(out.boxes[b, :k], r["boxes"][:k],
                                   rtol=0, atol=1e-4)
        torch.testing.assert_close(out.scores[b, :k], r["scores"][:k],
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(out.captions[b, :k].long(), r["tokens"][:k])


def test_other_entry_points_run(params):
    """Beam search and `extract_features` sit after the trunk; the serving
    engine builds from the tree."""
    from densecap_tpu_torch.serve.engine import InferenceEngine

    cfg = tiny()
    x, h, w = images()
    model = ckpt.to_torch(params, cfg, CPU)
    with torch.no_grad():
        beam = model.forward_test_batch(x, h, w, use_beam=3)
        boxes, codes, valid = model.extract_features(x, h, w, max_boxes=5)
    assert beam.captions.shape[:2] == (2, cfg.test_max_proposals)
    assert codes.shape == (2, 5, cfg.fc_dim) and bool(valid.any())
    eng = InferenceEngine(params, cfg, {}, device="cpu", max_boxes=3)
    try:
        rgb = np.random.default_rng(0).integers(0, 255, (90, 120, 3),
                                                dtype=np.uint8)
        got = eng.process_array(rgb)
    finally:
        eng.close()
    assert 0 < len(got["boxes"]) <= 3


def test_checkpoint_round_trip_and_run_model(params, tmp_path):
    from PIL import Image

    cfg = tiny()
    model = ckpt.to_torch(params, cfg, CPU)
    back = ckpt._flatten(ckpt.from_torch(model))
    flat = ckpt._flatten(params)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    path = tmp_path / "vit.npz"
    ckpt.save_params(str(path), params, extra={
        "meta": json.dumps({"config": cfg.to_json(), "vocab_size": 20})})
    loaded, _, cfg2 = ckpt.load_checkpoint(str(path))
    assert cfg2 == cfg
    x, h, w = images()
    with torch.no_grad():
        a = model.forward_test_batch(x, h, w)
        b = ckpt.to_torch(loaded, cfg2, CPU).forward_test_batch(x, h, w)
    assert torch.equal(a.boxes, b.boxes) and torch.equal(a.captions,
                                                         b.captions)

    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (96, 120, 3), dtype=np.uint8)).save(tmp_path / "a.jpg")
    out = tmp_path / "vis"
    run_model.main(["--checkpoint", str(path), "--input_image",
                    str(tmp_path / "a.jpg"), "--output_dir", str(out),
                    "--image_size", "128", "--num_proposals", "20",
                    "--pre_nms_topk", "100", "--device", "cpu"])
    (res,) = json.loads((out / "results.json").read_text())["results"]
    assert res["img_name"] == "a.jpg" and len(res["boxes"]) > 0
    assert len(res["captions"]) == len(res["boxes"])


def test_training_is_refused(params, tmp_path):
    with pytest.raises(ValueError, match=VIT_TRAINING):
        ckpt.to_torch(params, tiny(), CPU, train=True)
    with pytest.raises(ValueError, match=VIT_TRAINING):
        Trainer(ckpt.to_torch(params, tiny(), CPU))
    prefix = str(tmp_path / "vit")
    ckpt.save_params(prefix + ".npz", params)
    torch.save({"iter": 1}, prefix + ".optim.pt")
    with pytest.raises(ValueError, match=VIT_TRAINING):
        ckpt.load_train_state(prefix, tiny(), CPU)


def test_train_cli_refuses_a_vitdet_pair(params, dataset,  # noqa: F811
                                         tmp_path):
    from densecap_tpu_torch.cli import train as train_cli

    prefix = str(tmp_path / "vit")
    ckpt.save_params(prefix + ".npz", params)
    torch.save({"iter": 1}, prefix + ".optim.pt")
    with pytest.raises(ValueError, match=VIT_TRAINING):
        train_cli.main(_args(dataset, str(tmp_path / "out" / "d"), 1)
                       + ["--checkpoint_start_from", prefix])


def test_quantize_is_refused(params):
    with pytest.raises(SystemExit, match="--quantize int8: not supported"):
        maybe_quantize(params, "int8")
    assert maybe_quantize(params, "none") is params


def test_model_parallel_is_refused(params, monkeypatch):
    monkeypatch.setattr(distributed, "model_size", lambda: 2)
    with pytest.raises(ValueError, match="--model_parallel"):
        ckpt.to_torch(params, tiny(), CPU, train=True)


def test_spans_and_counters(params):
    """One recorded forward: each ViTDet span under `trunk` as often as a
    call has it, and the counters on `trunk`: 2 images x (two windowed
    blocks of 9 x 9 padded tokens + two global blocks of 8 x 8)."""
    cfg = tiny()
    model = ckpt.to_torch(params, cfg, CPU)
    since = prof.STORE.added
    was = prof.set_recording(True)
    try:
        with torch.no_grad():
            model.forward_test_batch(*images())
    finally:
        prof.set_recording(was)
    recs = list(prof.STORE.records)[len(prof.STORE.records)
                                    - (prof.STORE.added - since):]
    names = [r.name for r in recs if r.parent_name == "trunk"]
    assert {n: names.count(n) for n in set(names)} == {
        "vit.attn.window": 2, "vit.attn.global": 2, "vit.mlp": 4,
        "vit.neck": 1}
    (trunk,) = [r for r in recs if r.name == "trunk"]
    assert trunk.parent_name == "infer.forward"
    assert trunk.counters["vit.tokens"][0] == 2 * (2 * 81 + 2 * 64)
    assert trunk.counters["vit.pad_tokens"][0] == 2 * 2 * (81 - 64)


def test_vgg_config_json_is_unchanged():
    """A VGG-16 config writes none of the port's own fields (the trunk's,
    the text decoder's, `test_final_max_boxes`), so the JAX package reads
    its JSON; a ViTDet config's JSON reads back the same config."""
    from densecap_tpu.config import DenseCapConfig as JaxConfig
    from densecap_tpu_torch.config import PORT_ONLY

    cfg = DenseCapConfig(vocab_size=10000, image_size=544,
                         compute_dtype=torch.float32)
    d = json.loads(cfg.to_json())
    assert not [k for k in d if k.startswith(PORT_ONLY)]
    names = {f.name for f in dataclasses.fields(DenseCapConfig)}
    assert set(d) == {n for n in names if not n.startswith(PORT_ONLY)}
    assert {"trunk", "lm", "test_final_max_boxes"} <= names - set(d)
    jax_cfg = JaxConfig.from_json(cfg.to_json())
    assert jax_cfg.vocab_size == 10000 and jax_cfg.image_size == 544
    vit = tiny()
    assert DenseCapConfig.from_json(vit.to_json()) == vit
    with pytest.raises(ValueError, match="unknown trunk"):
        DenseCapConfig(trunk="vit_l")


@pytest.mark.parametrize("hw", [(3, 5), (4, 4), (1, 7)])
def test_attention_fold_matches_the_logits_written_out(hw):
    """The CPU path of the attention core (`vit_attention.fold`: the
    relative terms folded into one softmax product) against `plain`, the
    logits written out, which the card's kernel K6 is held to: f32
    operands, so they agree to f32 rounding."""
    from densecap_tpu_torch.ops import vit_attention as va

    hh, ww = hw
    g = torch.Generator().manual_seed(hh * 10 + ww)
    q, k, v = (torch.randn((2, hh * ww, 3, 16), generator=g)
               for _ in range(3))
    rh, rw = (torch.randn((2 * s - 1, 16), generator=g) for s in hw)
    got = va.attention(q, k, v, rh, rw, hw)
    ref = va.plain(q, k, v, rh, rw, hw)
    assert got.shape == q.shape
    assert float((got - ref).abs().max()) < F32_TOL


def test_k6_table_stacks_both_tables_in_bf16():
    """K6's table: Rh then Rw in bf16, zero rows to a multiple of 64."""
    from densecap_tpu_torch.ops import vit_attention as va

    rh, rw = torch.randn(27, 64), torch.randn(27, 64)
    t = va.table(rh, rw)
    assert t.shape == (64, 64) and t.dtype == torch.bfloat16
    assert torch.equal(t[:27], rh.bfloat16())
    assert torch.equal(t[27:54], rw.bfloat16())
    assert not t[54:].any()


def test_attention_keeps_k6_table_until_its_tables_change():
    """A block's `Attention.table` (K6's stack of its two tables) is made
    once and made again after an in-place change of either table, as the
    benchmark's control makes when it zeroes them."""
    from densecap_tpu_torch.models.vitdet import Attention
    from densecap_tpu_torch.ops import vit_attention as va

    g = torch.Generator().manual_seed(7)
    C = 128
    attn = Attention((torch.randn(C, 3 * C, generator=g), torch.zeros(3 * C)),
                     (torch.randn(C, C, generator=g), torch.zeros(C)),
                     torch.randn(13, 64, generator=g),
                     torch.randn(13, 64, generator=g), 2, torch.bfloat16)
    first = attn.table()
    assert attn.table() is first
    assert torch.equal(first, va.table(attn.rel_h, attn.rel_w))
    with torch.no_grad():
        attn.rel_h.zero_()
    again = attn.table()
    assert again is not first and not again[:13].any()
    assert torch.equal(again[13:26], attn.rel_w.bfloat16())
