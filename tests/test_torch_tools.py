"""The port's measurement scripts against the JAX package and the JAX
scripts, on the CPU at a tiny config (test_torch_slice's TINY, f32).

  * bench_torch.py's program (its inputs, `forward_test_batch`, its
    checksum) against JAX `forward_test_batch` on the same weights
    (bridged from JAX's `init_params`) and canvases: tokens, validity and
    `num` exact, boxes and scores within 1e-4 (the tolerance of
    tests/test_torch_slice.py), the checksum within 1e-4 relative;
  * the stage profilers' rows against the spans the program opens: the
    inference tool's against `forward_test_batch`'s (at both top-k
    branches), the train tool's against `Trainer.step`'s, and a span
    added to the program shows in the table with no edit to the tool;
  * `inference_flops` / `train_flops` against the FLOPs of every
    `dot_general` and `conv_general_dilated` in the JAX program's jaxpr
    (loop bodies times their trip counts; the decode's while loop runs
    the steps the captions say), equal after the two named differences
    (`jax_differences`); RoI align is the gather form in JAX and counted
    by neither;
  * the helpers copied from the JAX scripts byte-equal to theirs:
    `make_scenes`, `survivor_overlap`, `make_scene`, `synth_image`, and
    `make_batch`'s shapes and bytes;
  * beam search with the early exit on and off: the bench's tokens equal
    each other and JAX's `beamsearch` on the same codes, both ways;
  * the evaluator-scale records: the port's evaluator scores the JAX
    script's synthetic detections to the JAX evaluator's mAP within 1e-6.
"""

import importlib.util
import json
import os
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.eval.evaluator import (
    DenseCaptioningEvaluator as JaxEvaluator)
from densecap_tpu.models import densecap as jd
from densecap_tpu.models import lstm as jlstm
from densecap_tpu.parallel import train_step as jts
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.models import densecap
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.utils import profiling
from densecap_tpu_torch.utils.checkpoint import save_params, to_torch
from densecap_tpu_torch.utils.image import normalize_uint8_images

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import bench_torch  # noqa: E402
import torch_beam_early_exit_bench as beam_bench  # noqa: E402
import torch_eval_scale_bench as eval_bench  # noqa: E402
import torch_mfu_estimate as mfu  # noqa: E402
import torch_prenms_topk_check as topk_check  # noqa: E402
import torch_stage_profile_b8 as stage_b8  # noqa: E402
import torch_stage_profile_train as stage_train  # noqa: E402
import torch_tool_common as tc  # noqa: E402
import torch_transfer_latency_probe as probe  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=12, rnn_size=32, rnn_encoding_size=32,
            fc_dim=64, rpn_num_filters=32, sampler_batch_size=16,
            max_gt_boxes=8)
JCFG = JaxConfig(**TINY, compute_dtype=jnp.float32)
PCFG = DenseCapConfig(**TINY, compute_dtype=torch.float32)
SIZE_FLAGS = ["--vocab_size", "20", "--seq_length", "4", "--image_size", "96",
              "--proposals", "12", "--fc_dim", "64", "--rnn_size", "32",
              "--rpn_num_filters", "32", "--dtype", "float32",
              "--device", "cpu"]


def jax_script(name):
    """A JAX script loaded by path (its import-time environment changes
    undone)."""
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jd.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JCFG)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def test_bench_program_matches_jax(params):
    jp, np_params = params
    args = bench_torch.build_argparser().parse_args(
        SIZE_FLAGS + ["--batch", "2", "--canvas_w", "80"])
    batches, hs, ws = bench_torch.make_inputs(args, 96, torch.device("cpu"))
    assert batches.shape == (2, 2, 96, 80, 3) and float(ws[0]) == 72.0
    model = to_torch(np_params, PCFG, "cpu")
    forward = jax.jit(jd.forward_test_batch, static_argnums=4)
    for i in range(2):
        got = model.forward_test_batch(batches[i], hs, ws)
        ref = forward(jp, jnp.asarray(batches[i].numpy()),
                      jnp.asarray(hs.numpy()), jnp.asarray(ws.numpy()), JCFG)
        for name in ("valid", "num", "captions"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
        for name in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
        ref_sum = float(jnp.sum(ref.boxes) + jnp.sum(ref.scores)
                        + jnp.sum(ref.captions) + jnp.sum(ref.num))
        assert float(bench_torch.checksum(got)) == pytest.approx(ref_sum,
                                                                 rel=TOL)


def opened(fn):
    """(parent, name) of each span fn() opens, in the order it opens
    them."""
    was, since = profiling.set_recording(True), profiling.STORE.added
    try:
        fn()
    finally:
        profiling.set_recording(was)
    recs = list(profiling.STORE.records)[
        len(profiling.STORE.records) - (profiling.STORE.added - since):]
    return [(r.parent_name, r.name) for r in sorted(recs, key=lambda r: r.t0)]


@pytest.mark.parametrize("case", ["all_anchors", "presorted", "train"])
def test_stage_profile_rows_are_the_programs_spans(params, case):
    cpu = torch.device("cpu")
    if case == "train":
        cfg = PCFG.replace(drop_prob=0.5)
        trainer = Trainer(to_torch(params[1], cfg, "cpu", train=True),
                          learning_rate=1e-5)
        batch = tc.train_batch(cfg, 2, 96, 96, 72, cpu, valid_gt=3)
        batch["gt_boxes"][:, 1] = torch.tensor([40.0, 30.0, 24.0, 20.0])
        gen = torch.Generator().manual_seed(5)
        want = opened(lambda: trainer.step(batch, generator=gen))
        _, rows, _ = stage_train.profile(trainer, batch, gen, 2)
        root, own = stage_train.ROOT, []
    else:
        pre_k = {"all_anchors": 6000, "presorted": 64}[case]
        model = to_torch(params[1], PCFG.replace(test_pre_nms_topk=pre_k),
                         "cpu")
        raw, h, w = stage_b8.make_inputs(2, 96, 96, 72, cpu)
        want = opened(lambda: model.forward_test_batch(
            normalize_uint8_images(raw, h, w), h, w))
        _, rows, _ = stage_b8.profile(model, raw, h, w, 2)
        root, own = stage_b8.ROOT, [(None, "normalize")]
    assert want[0] == (None, root) and len(want) == len(set(want)) > 5
    assert [(r["parent"], r["name"]) for r in rows] == own + want
    assert {r["count"] for r in rows} == {2}
    (top,) = [r for r in rows if r["key"] == root]
    assert 0 < tc.children_sum(rows, root)["host_ms"] <= top["host_ms"]


def test_a_new_span_reaches_the_profiler_unedited(monkeypatch):
    real = densecap.nms

    def nms(*a, **k):
        with profiling.span("final_k1"):
            return real(*a, **k)

    monkeypatch.setattr(densecap, "nms", nms)
    buf = StringIO()
    with redirect_stdout(buf):
        stage_b8.main(SIZE_FLAGS + ["--batch", "2", "--reps", "1",
                                    "--iters", "1"])
    lines = buf.getvalue().splitlines()
    last = json.loads(lines[-1])
    keys = list(last["stages_ms"])
    assert keys.index("final_nms/final_k1") == keys.index(
        "infer.forward/final_nms") + 1
    assert any(line.startswith("    final_k1 ") for line in lines)


def jaxpr_flops(jaxpr, trips):
    """2 x multiply-adds of every dot_general and conv_general_dilated,
    sub-jaxprs included: a scan's body times its length, a while loop's
    body times `trips`, a cond's dearest branch."""
    total = 0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        out = int(np.prod(eqn.outvars[0].aval.shape)) if eqn.outvars else 0
        if p == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * out * int(np.prod([lhs[i] for i in lc]))
        elif p == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            cout = rhs[eqn.params["dimension_numbers"].rhs_spec[0]]
            total += 2 * out * int(np.prod(rhs)) // cout
        if p == "cond":
            total += max(jaxpr_flops(b.jaxpr, trips)
                         for b in eqn.params["branches"])
            continue
        for k, v in eqn.params.items():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, jcore.ClosedJaxpr):
                    sub = sub.jaxpr
                if not isinstance(sub, jcore.Jaxpr) or k == "cond_jaxpr":
                    continue
                mult = (eqn.params["length"] if p == "scan" else
                        trips if p == "while" else 1)
                total += mult * jaxpr_flops(sub, trips)
    return total


# The two programs differ from the port's in two products, by shape:
#  * inference: JAX vmaps the single-image decode, and the zero initial
#    state is not batched, so the first step's h @ Wh runs once on K rows
#    where the port runs it on B * K;
#  * training: JAX's scan transposes its carry uniformly, so it computes
#    the gradient of the zero initial state (h0 @ Wh's input) too.
def jax_differences(cfg, B, train):
    H = cfg.rnn_size
    if train:
        return 2 * B * (cfg.sampler_batch_size // 2) * H * 4 * H
    return -2 * (B - 1) * cfg.test_max_proposals * H * 4 * H


@pytest.mark.parametrize("W", [96, 80], ids=["square", "bucket"])
def test_inference_flops_match_jaxpr(params, W):
    jp, np_params = params
    B = 2
    ims = np.random.RandomState(0).standard_normal((B, 96, W, 3)).astype(
        np.float32) * 30
    hs, ws = jnp.full((B,), 96.0), jnp.full((B,), 72.0)
    out = to_torch(np_params, PCFG, "cpu").forward_test_batch(
        torch.from_numpy(ims), torch.full((B,), 96.0), torch.full((B,), 72.0))
    steps = mfu.decode_steps(out.captions.numpy(), 21, 4)
    jx = jax.make_jaxpr(lambda p, i: jd.forward_test_batch(
        p, i, hs, ws, JCFG))(jp, jnp.asarray(ims))
    got = mfu.inference_flops(PCFG, B, 96, W, steps)["total"]
    assert got + jax_differences(PCFG, B, False) == jaxpr_flops(jx.jaxpr,
                                                                steps)


@pytest.mark.parametrize("finetune", [False, True], ids=["frozen", "finetune"])
def test_train_flops_match_jaxpr(params, finetune):
    B, G, L = 2, JCFG.max_gt_boxes, JCFG.seq_length
    jc = JCFG.replace(static_freeze_cnn=not finetune)
    batch = {"image": jnp.zeros((B, 96, 96, 3)), "height": jnp.full((B,), 96.),
             "width": jnp.full((B,), 72.),
             "gt_boxes": jnp.tile(jnp.array([[[40., 30., 24., 20.]]]),
                                  (B, G, 1)),
             "gt_labels": jnp.ones((B, G, L), jnp.int32),
             "gt_valid": jnp.tile(jnp.arange(G) < 3, (B, 1))}
    state, tx = jts.init_state(None, jc, params=params[0])
    if finetune:
        state = state._replace(finetune_cnn=jnp.ones((), bool))
    jx = jax.make_jaxpr(lambda s, b: jts.train_step(
        s, b, jax.random.PRNGKey(3), jc, tx))(state, batch)
    got = mfu.train_flops(PCFG, B, 96, 96, finetune)["total"]
    assert got + jax_differences(PCFG, B, True) == jaxpr_flops(jx.jaxpr, 1)


def test_decode_steps():
    caps = np.array([[3, 21, 21, 21], [4, 5, 21, 21]])
    assert mfu.decode_steps(caps, 21, 4) == 3  # longest END at 2, plus one
    assert mfu.decode_steps(np.full((2, 4), 7), 21, 4) == 4  # never ends


def test_copied_helpers_are_byte_equal():
    jax_topk = jax_script("prenms_topk_check")
    a, b = jax_topk.make_scenes(2, seed=777), topk_check.make_scenes(2, 777)
    for x, y in zip(a[:4], b[:4]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a[4] == b[4]
    rng = np.random.RandomState(3)
    for n_a, n_b in ((5, 7), (0, 3), (4, 0)):
        boxes_a = np.abs(rng.standard_normal((n_a, 4)).astype(np.float32)
                         ) * 50 + 10
        boxes_b = np.concatenate([boxes_a[:2] + 1, np.abs(
            rng.standard_normal((n_b, 4)).astype(np.float32)) * 50 + 10])
        assert topk_check.survivor_overlap(boxes_a, boxes_b) == \
            jax_topk.survivor_overlap(boxes_a, boxes_b)

    jax_beam = jax_script("beam_early_exit_bench")
    got = beam_bench.make_scene(np.random.RandomState(0), 720, 720)
    ref = np.asarray(jax_beam.make_scene(np.random.RandomState(0), 720, 720))
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()

    jax_eval = jax_script("eval_scale_bench")
    r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
    vocab = eval_bench.vocabulary()
    for _ in range(3):
        for x, y in zip(jax_eval.synth_image(r1, 20, vocab),
                        eval_bench.synth_image(r2, 20, vocab)):
            if isinstance(x, np.ndarray):
                assert x.tobytes() == y.tobytes()
            else:
                assert x == y
    assert jax_eval.FAKE_JAR == eval_bench.FAKE_JAR

    jax_probe = jax_script("transfer_latency_probe")
    for raw in (True, False):
        a, b = jax_probe.make_batch(raw), probe.make_batch(raw)
        assert list(a) == list(b)
        for k in a:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_beam_early_exit_equal_tokens(params, tmp_path):
    jp, np_params = params
    ck = tmp_path / "tiny.npz"
    save_params(str(ck), np_params, extra={"meta": json.dumps({
        "config": PCFG.to_json()})})
    buf = StringIO()
    with redirect_stdout(buf):
        beam_bench.main(["--checkpoint", str(ck), "--image_size", "96",
                         "--proposals", "12", "--noise_image", "--iters", "1",
                         "--beam", "3", "--device", "cpu"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["lm"]["tokens_equal"] and res["full"]["tokens_equal"]
    # the same codes through JAX's beam search, early exit on and off
    model = to_torch(np_params, PCFG.replace(image_size=96), "cpu")
    img = torch.from_numpy(np.random.RandomState(0).randn(96, 96, 3).astype(
        np.float32) * 40 + 20)[None]
    h = torch.full((1,), 96.0)
    _, codes, _ = model.extract_features(img, h, h, max_boxes=12)
    codes = codes[0]
    got = model.lm.beamsearch(codes, 4, 3)[0].numpy()
    lmc = jlstm.LMConfig(20, 4, 32, 32, 64)
    for early in (True, False):
        ref = jlstm.beamsearch(jp["lm"], jnp.asarray(codes.numpy()), lmc,
                               beam_size=3, early_exit=early)
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_eval_scale_records_score_as_jax():
    ev, _ = eval_bench.add_results(12, 40, seed=0)
    scores = eval_bench.meteor.score_captions_fallback(ev.records)
    got, _ = eval_bench.pinned_evaluate(ev, scores)
    jax_eval = jax_script("eval_scale_bench")
    rng = np.random.RandomState(0)
    vocab = np.array([f"w{i}" for i in range(800)])
    jev = JaxEvaluator()
    for _ in range(12):
        jev.add_result(*jax_eval.synth_image(rng, 40, vocab))
    ref = jev.evaluate(verbose=False)
    assert ref["map"] > 0
    assert abs(got["map"] - ref["map"]) <= 1e-6
    assert abs(got["detmap"] - ref["detmap"]) <= 1e-6
