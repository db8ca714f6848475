"""GRiT's text decoder in the port (`models/textdec.py`) at a tiny size on
the CPU, held to the benchmark's plain reference
(`benchmark/reference/grit_ref.py`, loaded from its path): a decoder of
width 32, 4 heads, 2 layers and FFN 64 over a 3 x 3 object pool, on the
tiny ViTDet trunk of `test_torch_vitdet.py`, every bias and LayerNorm
off its init.

  * the prefill and the cached steps against the reference's full masked
    forward (no cache), teacher-forced, at every step: in f32 to 1e-5,
    in bf16 within 3e-2 (bf16 operands through two layers read ~6e-3
    here);
  * the benchmark control's three faults (`benchmark/control_grit.py`:
    the steps reading the layer before's prefix, the text positions
    shifted by one, fp8 products) each miss the f32 tolerance, and the
    reference without its prefix mask (object tokens seeing text)
    disagrees with the cached program;
  * `forward_test_batch` with `test_final_max_boxes` against the
    reference's whole forward in f32: its boxes, tokens and logprobs;
    without it, the LSTM configurations' outputs equal those with every
    proposal kept explicitly, and the ViT's extent rule equals VGG-16's;
  * a checkpoint round trip and `cli/run_model.py` on a tiny GRiT
    checkpoint; the refusals (training, `--quantize`, beam search);
  * a recorded forward's spans and counters.
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
from densecap_tpu_torch.models.textdec import TEXTDEC_BEAM, TEXTDEC_TRAINING
from densecap_tpu_torch.models.vgg16 import feat_extent
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.utils import checkpoint as ckpt
from densecap_tpu_torch.utils import profiling as prof
from test_torch_vitdet import images
from test_torch_vitdet import tiny as tiny_vit

torch.set_num_threads(2)
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_TOL = 3e-2
T = 5


def tiny(dtype=torch.float32, **kw):
    kw = {"test_final_max_boxes": 4, **kw}
    return tiny_vit(dtype, lm="grit_textdec", seq_length=T,
                    textdec_layers=2, textdec_dim=32, textdec_heads=4,
                    textdec_ffn=64, textdec_positions=8, textdec_obj_pool=3,
                    **kw)


def _bench_module(name):
    """A module of `benchmark/` by its path: `reference.<x>` in its
    package (for its relative imports), or a top-level file."""
    if name.startswith("reference."):
        pkg = "bench_reference"
        if pkg not in sys.modules:
            spec = importlib.util.spec_from_file_location(
                pkg, BENCH / "reference" / "__init__.py",
                submodule_search_locations=[str(BENCH / "reference")])
            mod = importlib.util.module_from_spec(spec)
            sys.modules[pkg] = mod
            spec.loader.exec_module(mod)
        return importlib.import_module(pkg + name[len("reference"):])
    spec = importlib.util.spec_from_file_location(
        "bench_" + name, BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def params():
    """init_params' tree with every bias and LayerNorm moved off its
    init, and the decoder's matrices 8 times BERT's 0.02 (at width 32 the
    attention is then far from uniform, so what each token sees
    matters)."""
    rng = np.random.default_rng(1)
    flat = ckpt._flatten(ckpt.init_params(tiny(), seed=0))
    for k, v in flat.items():
        if k.startswith("lm/layer") and v.ndim == 2:
            flat[k] = v * np.float32(8.0)
        if (k.startswith(("vit/", "lm/")) and (k.endswith("/b")
                                              or "norm" in k or "_ln/" in k
                                              or "/ln" in k)):
            flat[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return ckpt._unflatten(flat)


@pytest.fixture(scope="module")
def control():
    return _bench_module("control_grit")


def reference(params, cfg=None, **kw):
    tree = ckpt._unflatten({k: torch.from_numpy(np.array(v))
                            for k, v in ckpt._flatten(params).items()})
    d = dataclasses.asdict(cfg or tiny())
    del d["compute_dtype"]
    return _bench_module("reference.grit_ref").GritReference(tree, d, **kw)


def prefix_inputs(seed=0):
    """One image's (C, 8, 8) feature map, a canvas of 128 x 112, and 5
    boxes on it; the tokens each row is teacher-forced with."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((32, 8, 8), generator=g)
    xy = torch.rand((5, 2), generator=g) * torch.tensor([100.0, 110.0]) + 8
    wh = torch.rand((5, 2), generator=g) * 60 + 10
    tokens = torch.randint(1, 22, (5, T), generator=g)
    return feats, torch.cat([xy, wh], 1), tokens


def step_logits(model, feats, boxes, tokens, h=128.0, w=112.0):
    """The program's logits (n, T, V + 1) for teacher-forced `tokens`:
    its prefill, then one cached step a position."""
    lm = model.lm
    hw = torch.tensor([h]), torch.tensor([w])
    extent = model.feat_extent(*hw)
    with torch.no_grad():
        cache = lm.prefill(feats.permute(1, 2, 0)[None].contiguous(),
                           boxes[None], *hw, extent, T)
        tok = torch.full((boxes.shape[0],), lm.vocab_size + 1)
        out = []
        for t in range(T):
            out.append(lm.project(lm.step(tok, t, cache)))
            tok = tokens[:, t]
    return torch.stack(out, 1)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def want_logits(params, feats, boxes, tokens, **kw):
    ref = reference(params, **kw)
    with torch.no_grad():
        return ref.teacher_logits(
            ref.object_features(feats, boxes, 128.0, 112.0), tokens)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_cached_steps_match_the_full_forward(params, dtype, tol):
    feats, boxes, tokens = prefix_inputs()
    want = want_logits(params, feats, boxes, tokens)
    got = step_logits(ckpt.to_torch(params, tiny(dtype), CPU), feats, boxes,
                      tokens)
    assert got.shape == want.shape == (5, T, 21)
    for t in range(T):
        assert rel(got[:, t], want[:, t]) < tol, t


@pytest.mark.parametrize("kind", ["prefix_layer", "shift", "fp8"])
def test_control_faults_miss_the_full_forward(params, control, kind):
    feats, boxes, tokens = prefix_inputs()
    want = want_logits(params, feats, boxes, tokens)
    model = ckpt.to_torch(params, tiny(), CPU)
    with control.FAULTS[kind]():
        got = step_logits(model, feats, boxes, tokens)
    assert max(rel(got[:, t], want[:, t]) for t in range(T)) > 10 * F32_TOL
    assert rel(step_logits(model, feats, boxes, tokens), want) < F32_TOL


def test_reference_without_its_prefix_mask_disagrees(params):
    feats, boxes, tokens = prefix_inputs()
    bare = want_logits(params, feats, boxes, tokens, prefix_mask=False)
    got = step_logits(ckpt.to_torch(params, tiny(), CPU), feats, boxes,
                      tokens)
    assert rel(got, bare) > 10 * F32_TOL


def test_forward_test_batch_matches_reference(params):
    """At a final NMS of 0.7 some 14 boxes an image survive, and the cut
    keeps the best 4."""
    cfg = tiny(test_final_nms_thresh=0.7)
    x, h, w = images()
    ref = reference(params, cfg)
    model = ckpt.to_torch(params, cfg, CPU)
    with torch.no_grad():
        out = model.forward_test_batch(x, h, w)
        want = [ref.forward_test(x[b], h[b], w[b]) for b in range(2)]
    assert out.boxes.shape == (2, 4, 4) and out.captions.shape == (2, 4, T)
    for b, r in enumerate(want):
        k = int(r["valid"].sum())
        assert int(out.num[b]) == k == 4
        torch.testing.assert_close(out.boxes[b, :k], r["boxes"][:k], rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(out.scores[b, :k], r["scores"][:k],
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(out.captions[b, :k].long(), r["tokens"][:k])
        torch.testing.assert_close(out.caption_logprobs[b, :k],
                                   r["logprobs"][:k], rtol=0, atol=1e-5)


def test_no_final_nms_keeps_every_proposal(params):
    """`test_final_max_boxes` cuts what the final NMS keeps: with no final
    NMS every proposal is decoded, in recog's order."""
    cfg = tiny()
    x, h, w = images()
    model = ckpt.to_torch(params, cfg, CPU)
    with torch.no_grad():
        out = model.forward_test_batch(x, h, w, final_nms_thresh=0.0)
        det = model._detect(x, h, w)
    K = cfg.test_max_proposals
    assert K > cfg.test_final_max_boxes
    assert out.boxes.shape == (2, K, 4) and out.captions.shape == (2, K, T)
    assert torch.equal(out.boxes, det.boxes)
    assert torch.equal(out.valid, det.valid)


@pytest.mark.parametrize("trunk", ["vgg16", "vitdet_b"])
def test_unset_final_max_boxes_keeps_the_lstm_outputs(trunk):
    """Without `test_final_max_boxes` the final NMS keeps every proposal,
    as before the field: bit-equal to the same config with it set to K."""
    if trunk == "vgg16":
        cfg = dataclasses.replace(tiny_vit(), trunk="vgg16",
                                  test_max_proposals=12)
        x, h, w = images(H=96, W=96)
        h, w = torch.tensor([96.0, 70.0]), torch.tensor([96.0, 80.0])
    else:
        cfg = tiny_vit()
        x, h, w = images()
    params = ckpt.init_params(cfg, seed=3)
    K = cfg.test_max_proposals
    with torch.no_grad():
        a = ckpt.to_torch(params, cfg, CPU).forward_test_batch(x, h, w)
        b = ckpt.to_torch(params, cfg.replace(test_final_max_boxes=K),
                          CPU).forward_test_batch(x, h, w)
    assert a.boxes.shape[1] == K
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_vit_extent_rule_equals_vgg16s():
    model = ckpt.to_torch(ckpt.init_params(tiny_vit(), seed=0), tiny_vit(),
                          CPU)
    hw = torch.arange(0, 2048, dtype=torch.float32)
    for got, want in zip(model.feat_extent(hw, hw.flip(0)),
                         feat_extent(hw, hw.flip(0))):
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_checkpoint_round_trip_and_run_model(params, tmp_path):
    from PIL import Image

    cfg = tiny()
    model = ckpt.to_torch(params, cfg, CPU)
    back = ckpt._flatten(ckpt.from_torch(model))
    flat = ckpt._flatten(params)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    path = tmp_path / "grit.npz"
    ckpt.save_params(str(path), params, extra={
        "meta": json.dumps({"config": cfg.to_json(), "vocab_size": 20})})
    loaded, _, cfg2 = ckpt.load_checkpoint(str(path))
    assert cfg2 == cfg
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (96, 120, 3), dtype=np.uint8)).save(tmp_path / "a.jpg")
    argv = ["--checkpoint", str(path), "--input_image",
            str(tmp_path / "a.jpg"), "--output_dir", str(tmp_path / "vis"),
            "--image_size", "128", "--num_proposals", "20",
            "--pre_nms_topk", "100", "--device", "cpu"]
    run_model.main(argv)
    (res,) = json.loads((tmp_path / "vis" / "results.json").read_text())[
        "results"]
    assert 0 < len(res["boxes"]) <= 4
    assert len(res["captions"]) == len(res["boxes"])
    with pytest.raises(ValueError, match=TEXTDEC_BEAM):
        run_model.main(argv + ["--beam_size", "3"])
    with pytest.raises(ValueError, match="the config's lm is 'lstm'"):
        ckpt.to_torch(params, cfg.replace(lm="lstm"), CPU)


def test_training_quantize_and_beam_are_refused(params, tmp_path):
    with pytest.raises(ValueError, match=TEXTDEC_TRAINING):
        ckpt.to_torch(params, tiny(), CPU, train=True)
    model = ckpt.to_torch(params, tiny(), CPU)
    with pytest.raises(ValueError, match=TEXTDEC_TRAINING):
        Trainer(model)
    prefix = str(tmp_path / "grit")
    ckpt.save_params(prefix + ".npz", params)
    torch.save({"iter": 1}, prefix + ".optim.pt")
    with pytest.raises(ValueError, match=TEXTDEC_TRAINING):
        ckpt.load_train_state(prefix, tiny(), CPU)
    with pytest.raises(SystemExit, match="--quantize int8: not supported "
                                         "with GRiT's text decoder"):
        maybe_quantize(params, "int8")
    with pytest.raises(ValueError, match=TEXTDEC_BEAM):
        model.forward_test_batch(*images(), use_beam=3)


def test_spans_and_counters(params):
    """One recorded forward: `textdec.prefix` and `textdec.decode` under
    the forward, T `textdec.attn` spans a layer under the decode, and its
    counters: T steps and T + 1 reads, no K4 step on the CPU."""
    model = ckpt.to_torch(params, tiny(), CPU)
    since = prof.STORE.added
    was = prof.set_recording(True)
    try:
        with torch.no_grad():
            model.forward_test_batch(*images())
    finally:
        prof.set_recording(was)
    recs = list(prof.STORE.records)[len(prof.STORE.records)
                                    - (prof.STORE.added - since):]
    by = {n: [r for r in recs if r.name == n]
          for n in ("textdec.prefix", "textdec.decode", "textdec.attn")}
    assert [r.parent_name for r in by["textdec.prefix"]] == ["infer.forward"]
    assert [r.parent_name for r in by["textdec.decode"]] == ["infer.forward"]
    assert {r.parent_name for r in by["textdec.attn"]} == {"textdec.decode"}
    assert len(by["textdec.attn"]) == 2 * T
    counters = by["textdec.decode"][0].counters
    assert counters["textdec.steps"][0] == T
    assert counters["decode.reads"][0] == T
    assert "decode.head_steps" not in counters


def test_config_json_round_trip():
    cfg = tiny()
    d = json.loads(cfg.to_json())
    assert d["lm"] == "grit_textdec" and d["test_final_max_boxes"] == 4
    from densecap_tpu_torch.config import DenseCapConfig

    assert DenseCapConfig.from_json(cfg.to_json()) == cfg
    with pytest.raises(ValueError, match="unknown lm"):
        DenseCapConfig(lm="gpt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_steps_stay_eager(params, dtype):
    """Off the card no step replays a graph, in either dtype: the decoder
    keeps no graph state, each prefill hands out a cache of its own, and
    a recorded forward counts no `textdec.graph_steps`, one `textdec.attn`
    a layer a step."""
    model = ckpt.to_torch(params, tiny(dtype), CPU)
    lm = model.lm
    feats, boxes, _ = prefix_inputs()
    hw = torch.tensor([128.0]), torch.tensor([112.0])
    args = (feats.permute(1, 2, 0)[None].contiguous(), boxes[None], *hw,
            model.feat_extent(*hw), T)
    with torch.no_grad():
        assert lm.prefill(*args) is not lm.prefill(*args)
    since = prof.STORE.added
    was = prof.set_recording(True)
    try:
        with torch.no_grad():
            model.forward_test_batch(*images())
    finally:
        prof.set_recording(was)
    recs = list(prof.STORE.records)[len(prof.STORE.records)
                                    - (prof.STORE.added - since):]
    decode = [r for r in recs if r.name == "textdec.decode"]
    assert len(decode) == 1
    steps = decode[0].counters["textdec.steps"][0]
    assert steps == T and "textdec.graph_steps" not in decode[0].counters
    assert sum(r.name == "textdec.attn" for r in recs) == 2 * steps
    assert lm._graphs is None


def test_successive_forwards_keep_their_outputs(params):
    """A forward's outputs stay as they were while the next forward, on
    other images, runs: no call hands out a buffer a later call
    rewrites."""
    model = ckpt.to_torch(params, tiny(), CPU)
    with torch.no_grad():
        first = model.forward_test_batch(*images(seed=1))
        kept = [t.clone() for t in (first.boxes, first.captions,
                                    first.caption_logprobs)]
        second = model.forward_test_batch(*images(seed=2))
    assert not torch.equal(second.caption_logprobs, kept[2])
    for t, k in zip((first.boxes, first.captions, first.caption_logprobs),
                    kept):
        assert torch.equal(t, k)
