"""The port's learning checks against the JAX package's scripts, on the CPU.

  * the scene module (`scripts/torch_synth_scenes.py`) gives byte-equal
    arrays and equal texts to `overfit_sanity.make_dataset` (both sizes),
    `generalize_check.make_scenes` and `trained_weights_bench.make_dataset`
    (run in a subprocess: importing that script points JAX's persistent
    compilation cache at a directory);
  * the new box functions and `eval_box_recall` against
    `densecap_tpu.ops.boxes` (exact keys, values within 1e-6);
  * the schedules the twins build against `optax.cosine_decay_schedule`
    (1e-9), their batch draws against the JAX scripts' own expression, and
    the small overfit config against the JAX script's;
  * three training steps of the small overfit config from
    `init_params(cfg, seed=0)`, the sampler pinned by debug ordinals, f32,
    against the JAX loss, gradient zones and `optax` cosine Adam of
    `train_step` (which draws its sampler key, so the test builds it from
    `forward_train(debug_sampler=...)`). Finetuning on, step by step: at
    each step the port's `Trainer` built from the JAX state before it
    (`scripts/torch_import_jax_state.trainer_from_jax`), losses within
    1e-4 relative and the parameters after every step within the bounds
    stated at the test. Free-running, each package on its own state: with
    the trunk frozen, losses within 1e-4 at every step and the parameters
    after step 3 within the bounds stated there; finetuning on, the port
    parts from JAX by at most 5x what JAX parts from itself after a
    one-ulp change of trunk2's weights (`free_running` says why);
  * the overfit and generalisation twins' `main` at `--steps 2 --device
    cpu`, run to the end.
"""

import ast
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.ops import boxes as jb
from densecap_tpu.parallel import train_step as jts
from densecap_tpu_torch.ops import boxes as tb
from densecap_tpu_torch.parallel.train_step import (Trainer,
                                                    cosine_decay_schedule)
from densecap_tpu_torch.utils.checkpoint import (from_torch, init_params,
                                                 to_torch)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
sys.path.insert(0, str(SCRIPTS))

import generalize_check  # noqa: E402
import overfit_sanity  # noqa: E402
import torch_generalize_check  # noqa: E402
import torch_overfit_sanity  # noqa: E402
import torch_synth_scenes as scenes  # noqa: E402
from torch_import_jax_state import trainer_from_jax  # noqa: E402

torch.set_num_threads(2)


def _same_arrays(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert g.tobytes() == r.tobytes()


# ---------------------------------------------------------------------------
# (a) the scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["192px", "full"])
def test_overfit_scenes_equal_the_jax_script(full, monkeypatch):
    monkeypatch.setattr(overfit_sanity, "FULL", full)
    monkeypatch.setattr(overfit_sanity, "S", 720 if full else 192)
    ref = overfit_sanity.make_dataset()
    got = scenes.overfit_scenes(full)
    _same_arrays(got[:4], ref[:4])
    assert got[4] == ref[4]


@pytest.mark.parametrize("n,seed", [(160, 0), (16, 777)])
def test_box_scenes_equal_generalize_check(n, seed):
    ref = generalize_check.make_scenes(n, seed)
    got = scenes.box_scenes(n, seed)
    _same_arrays(got[:4], ref[:4])
    assert got[4] == ref[4]


DUMP_BENCH = """
import sys
import numpy as np
sys.path.insert(0, "scripts")
import trained_weights_bench as t
np.savez(sys.argv[1], *t.make_dataset())
print(t.WORDS == sys.argv[2].split(","), [t.caption_for(c, s) for c in t.COLORS
      for s in ("small", "large")])
"""


def test_caption_scenes_equal_trained_weights_bench(tmp_path):
    out = tmp_path / "bench.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", DUMP_BENCH, str(out),
         ",".join(scenes.CAPTION_WORDS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    caps = [scenes.caption_for(c, s) for c in scenes.COLORS
            for s in ("small", "large")]
    assert proc.stdout.strip() == f"True {caps}"
    with np.load(out) as ref:
        _same_arrays(scenes.caption_scenes(),
                     [ref[f"arr_{i}"] for i in range(4)])


# ---------------------------------------------------------------------------
# (b) box functions
# ---------------------------------------------------------------------------

def _boxes(seed, n, lo=1.0, hi=120.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(2.0, 60.0, (n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["xywh_to_x1y1x2y2", "x1y1x2y2_to_xywh",
                                  "xywh_to_xcycwh", "xcycwh_to_xywh"])
def test_conversions_match_jax(name, seed):
    b = _boxes(seed, 30).reshape(3, 10, 4)
    got = getattr(tb, name)(torch.from_numpy(b)).numpy()
    ref = np.asarray(getattr(jb, name)(jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frac", [0.5, 720 / 1024])
def test_scale_boxes_xywh_matches_jax(frac):
    b = _boxes(3, 25)
    got = tb.scale_boxes_xywh(torch.from_numpy(b), frac).numpy()
    ref = np.asarray(jb.scale_boxes_xywh(jnp.asarray(b), frac))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [4, 5])
def test_iou_matrix_matches_jax(seed):
    b = np.array(jb.xcycwh_to_x1y1x2y2(jnp.asarray(_boxes(seed, 40))))
    got = tb.iou_matrix(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.iou_matrix(b)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.diag(got), 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ns,threshs", [
    ((10, 50), (0.5,)),
    ((1, 7, 30, 31, 100), (0.3, 0.5, 0.7, 0.9)),  # 31 and 100 > N = 30
])
def test_eval_box_recall_matches_jax(seed, ns, threshs):
    rng = np.random.default_rng(seed)
    gt = _boxes(seed + 10, 6, 20.0, 100.0)
    # proposals: jittered copies of the gt and random boxes, shuffled
    near = np.repeat(gt, 3, 0) + rng.normal(0, 4, (18, 4)).astype(np.float32)
    props = np.concatenate([near, _boxes(seed + 20, 12)])[rng.permutation(30)]
    got = tb.eval_box_recall(torch.from_numpy(props), torch.from_numpy(gt),
                             ns=ns, iou_threshs=threshs)
    ref = jb.eval_box_recall(jnp.asarray(props), jnp.asarray(gt), ns=ns,
                             iou_threshs=threshs)
    assert list(got) == list(ref)
    assert all(k.endswith(("_at_1", "_at_7", "_at_10", "_at_30"))
               for k in got)  # n > N gives no key
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    assert max(got.values()) > 0


# ---------------------------------------------------------------------------
# (c) schedules, batch draws and the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,alpha", [(6000, 0.02), (4000, 0.05),
                                         (1500, 0.02)])
def test_cosine_schedules_match_optax(steps, alpha):
    got = cosine_decay_schedule(3e-4, steps, alpha=alpha)
    ref = optax.cosine_decay_schedule(3e-4, steps, alpha=alpha)
    for count in (0, 1, steps // 2, steps - 1, steps):
        assert abs(got(count) - float(ref(count))) <= 1e-9, count


def _jax_script_draw(path):
    """The expression the JAX script assigns to `sel` in its loop."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "sel"):
            return compile(ast.Expression(node.value), str(path), "eval")
    raise AssertionError(f"no sel = ... in {path}")


@pytest.mark.parametrize("script,n,b", [
    ("overfit_sanity.py", 16, 4), ("generalize_check.py", 160, 8),
    ("trained_weights_bench.py", 16, 4)])
def test_batch_draws_equal_the_jax_scripts(script, n, b):
    expr = _jax_script_draw(SCRIPTS / script)
    names = {"np": np, "N_IMAGES": n, "n_train": n, "B": b, "B_TRAIN": b}
    for it in (0, 1, 2, 77, 5999):
        ref = eval(expr, dict(names, it=it))
        np.testing.assert_array_equal(
            torch_overfit_sanity.batch_indices(it, n, b), ref)


# the JAX script's small config (overfit_sanity.py:88-100), as written there
JAX_SMALL = dict(vocab_size=5, seq_length=3, image_size=192,
                 anchors=((32, 32), (64, 64), (48, 96), (96, 48), (96, 96)),
                 sampler_batch_size=64, max_gt_boxes=4, test_max_proposals=50,
                 test_pre_nms_topk=-1, rnn_size=64, rnn_encoding_size=64,
                 fc_dim=256, rpn_num_filters=64, drop_prob=0.0)
JAX_FULL = dict(vocab_size=5, seq_length=3, image_size=720,
                sampler_batch_size=128, max_gt_boxes=4, test_max_proposals=50,
                drop_prob=0.0)


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_overfit_configs_equal_the_jax_script(full):
    port = torch_overfit_sanity.overfit_config(full)
    assert JaxConfig.from_json(port.to_json()) == JaxConfig(
        **(JAX_FULL if full else JAX_SMALL))


# ---------------------------------------------------------------------------
# (d) three training steps against JAX
# ---------------------------------------------------------------------------

STEPS, B = 3, 4
P, M = 32, 64  # the sampler's positive and total slots at batch size 64
LR = optax.cosine_decay_schedule(3e-4, 6000, alpha=0.02)
LOSS_KEYS = ("mid_objectness_loss", "mid_box_reg_loss", "box_decay_loss",
             "end_objectness_loss", "end_box_reg_loss", "captioning_loss",
             "total_loss")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def small():
    """The small overfit config at f32, its weights from
    `init_params(cfg, seed=0)`, the three batches of the twin's draw with
    the sampler pinned by debug ordinals, and the jitted gradient of the
    JAX loss (`forward_train` with the sampler pinned: `train_step`
    itself draws its sampler key)."""
    pcfg = torch_overfit_sanity.overfit_config().replace(
        compute_dtype=torch.float32)
    jcfg = JaxConfig.from_json(pcfg.to_json())
    assert jcfg.compute_dtype == jnp.float32
    images, gt_boxes, gt_labels, gt_valid, _ = scenes.overfit_scenes()
    rng = np.random.default_rng(11)
    batches = []
    for it in range(STEPS):
        sel = torch_overfit_sanity.batch_indices(it, 16, B)
        batches.append(dict(
            image=images[sel], height=np.full(B, 192.0, np.float32),
            width=np.full(B, 192.0, np.float32), gt_boxes=gt_boxes[sel],
            gt_labels=gt_labels[sel], gt_valid=gt_valid[sel],
            dbg={"pos": rng.permutation(P).astype(np.int32),
                 "neg": rng.permutation(M).astype(np.int32)}))

    def loss_fn(p, b):
        dbg = {k: jnp.asarray(v) for k, v in b["dbg"].items()}
        per = jax.vmap(lambda im, h, w, gb, gl, gv: jd.forward_train(
            p, im, h, w, gb, gl, gv, jax.random.PRNGKey(0), jcfg,
            debug_sampler=dbg))(
            b["image"], b["height"], b["width"], b["gt_boxes"],
            b["gt_labels"], b["gt_valid"])
        losses = jax.tree_util.tree_map(jnp.mean, per)
        return losses["total_loss"], losses

    return dict(pcfg=pcfg, jcfg=jcfg, params=init_params(pcfg, seed=0),
                batches=batches,
                grad_fn=jax.jit(jax.grad(loss_fn, has_aux=True)))


def _jax_steps(small, params, finetune=True):
    """JAX's steps from `params`, free-running: train_step's zones, weight
    decay and optax cosine Adam (the cnn zone's gradient kept while
    finetuning). Yields (losses, the state before the step, gradients,
    the parameters after it) per step."""
    jcfg = small["jcfg"]
    tx = jts.make_optimizer(jcfg, learning_rate=LR)
    zones = jts.param_zones(params)
    kept = ("main", "cnn") if finetune else ("main",)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for b in small["batches"]:
        before = (jax.tree_util.tree_map(np.asarray, jp), opt_state)
        grads, losses = small["grad_fn"](jp, b)
        grads = {k: (jax.tree_util.tree_map(
            lambda gi, pi: gi + jcfg.weight_decay * pi, g, jp[k])
            if zones[k] in kept else jax.tree_util.tree_map(jnp.zeros_like,
                                                            g))
            for k, g in grads.items()}
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        yield ({k: float(losses[k]) for k in LOSS_KEYS}, before, grads, jp)


def _port_step(trainer, b):
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
             if k != "dbg"}
    batch["gt_labels"] = batch["gt_labels"].long()
    port = trainer.step(batch, debug_sampler={
        k: torch.from_numpy(v) for k, v in b["dbg"].items()})
    return {k: float(port[k]) for k in LOSS_KEYS}


def _schedule():
    return cosine_decay_schedule(3e-4, 6000, alpha=0.02)


@pytest.fixture(scope="module")
def three_steps(small):
    """Three JAX steps from `init_params(cfg, seed=0)`, finetuning on, and
    at each the port's Trainer built from the JAX state before it
    (parameters, each zone's Adam moments and counts, the schedule's
    count) and stepped on the same batch: each step from the same state.
    The free-running runs are held below (`free_running`)."""
    steps = []
    for it, (losses, (before, opt_state), grads, jp) in enumerate(
            _jax_steps(small, small["params"])):
        trainer = trainer_from_jax(before, opt_state, small["pcfg"], it,
                                   True, learning_rate=_schedule())
        assert trainer.count == it and trainer.finetune_cnn
        steps.append(dict(
            jax_losses=losses,
            port_losses=_port_step(trainer, small["batches"][it]),
            before=_flat(before), jax_params=_flat(jp),
            port_params=_flat(from_torch(trainer.model)), grads=_flat(grads),
            lr=float(LR(it))))
    return steps


@pytest.mark.parametrize("step", range(STEPS))
def test_steps_losses_match_jax(three_steps, step):
    got, ref = (three_steps[step]["port_losses"],
                three_steps[step]["jax_losses"])
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"step {step} {k}")
    assert got["captioning_loss"] > 0 and got["mid_objectness_loss"] > 0


@pytest.mark.parametrize("step", range(STEPS))
def test_steps_parameters_match_jax(three_steps, step):
    s = three_steps[step]
    got, ref, before, g, lr = (s["port_params"], s["jax_params"],
                               s["before"], s["grads"], s["lr"])
    assert set(got) == set(ref)
    for k in ref:
        if k.startswith("trunk1/"):  # the frozen zone
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(ref[k], before[k], err_msg=k)
            continue
        assert np.abs(got[k] - before[k]).max() > 0, f"{k} did not move"
        # Adam's step is at most about lr (|m| <= sqrt(v) while young):
        # where |g| is at the level of the two packages' rounding the
        # signs may differ, by at most 2 lr; where |g| is large (> 0.1 of
        # the leaf's largest) the steps agree to 1e-2 lr
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2 * lr + 1e-6, k
        big = np.abs(g[k]) > 0.1 * np.abs(g[k]).max()
        assert diff[big].max(initial=0.0) <= 1e-2 * lr, k


def _nudged(params):
    """`params` with every trunk2 weight moved one f32 ulp up: the least
    change f32 can make."""
    out = dict(params)
    out["trunk2"] = {k: dict(v, w=np.nextafter(v["w"], np.float32(np.inf)))
                     for k, v in params["trunk2"].items()}
    return out


def _loss_parting(a, b):
    """Per step, the largest relative difference of two runs' losses."""
    return [max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6) for k in LOSS_KEYS)
            for x, y in zip(a, b)]


@pytest.fixture(scope="module")
def free_running(small, three_steps):
    """Three steps free-running from one set of weights, each package on
    its own state throughout: with the trunk frozen (finetuning off), the
    port's Trainer against JAX; finetuning on, the port's Trainer against
    JAX (the JAX run of `three_steps`, which runs free), and JAX against
    JAX from `_nudged` weights.

    Finetuning on, the two packages part after step 1 (losses ~3e-4
    relative at step 2, ~5e-3 at step 3), and so does JAX from itself
    after a one-ulp change of trunk2's weights (~3e-4, ~2e-3): at this
    random init trunk2's convolution gradients are sensitive to
    rounding, and Adam's early update, about lr * sign(g), carries every
    flipped sign into the next loss. With the trunk frozen no gradient
    is that sensitive, and the runs agree."""
    pcfg, params = small["pcfg"], small["params"]
    out = {}
    for finetune in (False, True):
        trainer = Trainer(to_torch(params, pcfg, "cpu", train=True),
                          learning_rate=_schedule())
        trainer.set_finetune(finetune)
        out[f"port_{finetune}"] = [_port_step(trainer, b)
                                   for b in small["batches"]]
        out[f"port_params_{finetune}"] = _flat(from_torch(trainer.model))
    jax_off = list(_jax_steps(small, params, finetune=False))
    out["jax_False"] = [s[0] for s in jax_off]
    out["jax_params_False"] = _flat(jax_off[-1][3])
    out["jax_grads_False"] = _flat(jax_off[-1][2])
    out["before"] = _flat(params)
    out["jax_True"] = [s["jax_losses"] for s in three_steps]
    out["jax_nudged"] = [s[0] for s in _jax_steps(small, _nudged(params))]
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_free_running_trunk_frozen_losses_match_jax(free_running, step):
    got, ref = free_running["port_False"][step], free_running["jax_False"][step]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"step {step} {k}")


def test_free_running_trunk_frozen_parameters_match_jax(free_running):
    got, ref, before, g = (free_running["port_params_False"],
                           free_running["jax_params_False"],
                           free_running["before"],
                           free_running["jax_grads_False"])
    lrs = [float(LR(it)) for it in range(STEPS)]
    for k in ref:
        if k.startswith(("trunk1/", "trunk2/")):  # frozen with the trunk
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(ref[k], before[k], err_msg=k)
            continue
        # after three steps: where a sign flipped at the level of rounding
        # at most 2 lr a step; where |g| of the last step is large (> 0.1
        # of the leaf's largest) within 0.1 lr
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2 * sum(lrs) + 1e-6, k
        big = np.abs(g[k]) > 0.1 * np.abs(g[k]).max()
        assert diff[big].max(initial=0.0) <= 0.1 * lrs[-1], k


def test_jax_from_itself_parts_with_finetuning(free_running):
    """The premise of the next test: free-running with finetuning on, JAX
    parts from itself, after a one-ulp change of trunk2's weights, by more
    than the 1e-4 of the step-by-step test."""
    floor = _loss_parting(free_running["jax_nudged"], free_running["jax_True"])
    assert floor[-1] > 1e-4, floor


@pytest.mark.parametrize("step", range(STEPS))
def test_free_running_finetune_parts_as_jax_from_itself(free_running, step):
    """Finetuning on, free-running: the port parts from JAX by at most 5x
    what JAX parts from itself after a one-ulp change of trunk2's weights
    (and within 1e-4 while that is smaller)."""
    got = _loss_parting(free_running["port_True"], free_running["jax_True"])
    floor = _loss_parting(free_running["jax_nudged"], free_running["jax_True"])
    assert got[step] <= max(1e-4, 5 * floor[step]), (got, floor)


# ---------------------------------------------------------------------------
# (e) the twins' main on the CPU
# ---------------------------------------------------------------------------

def test_overfit_main_runs_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit,
                                             match="never learned"):
        torch_overfit_sanity.main(["--steps", "2", "--device", "cpu"])
    text = out.getvalue()
    assert "it    1 total" in text
    assert "RPN recall@50 iou0.5 on 4 imgs:" in text
    assert "train-set mAP:" in text and "busy share not measured" in text


def test_generalize_main_runs_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        res = torch_generalize_check.main(["--steps", "2", "--device", "cpu"])
    assert "HELD-OUT mAP:" in out.getvalue()
    assert 0.0 <= res["map"] <= 1.0 and 0.0 <= res["detmap"] <= 1.0
