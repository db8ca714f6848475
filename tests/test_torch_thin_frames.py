"""Frames too thin for a feature cell: the port answers them as the JAX
package does.

A side that scales under 16 px leaves a feature extent of 0: the trunk
zeroes the whole map, no anchor is valid, and the JAX package answers
with no regions. The port runs such a frame through the model like any
other, on every path:

  * RoI align at extents 0 and 1 against the JAX gather, forward and
    both gradients, on features zeroed outside the extent as the trunk
    leaves them. Within 1e-6 of the largest reference entry (the JAX
    positions are f64 under the suite's x64, the port's f32). At extent
    0 the port's clamp taps cell 0 where JAX's clip to -1 wraps to the
    map's last cell: both are outside the extent, so d feats is compared
    inside it, where the trunk's mask lets it through;
  * an oversized extent (a caller error the host's canvas check keeps
    from both packages): the port's forward equals the JAX gather's,
    which clamps its indices the same way, within 1e-5 (positions along
    a whole extent, as in test_torch_roi_align.py);
  * one train step with a thin frame in the batch: losses within rtol
    1e-4 and every gradient within 1e-3 of its largest entry, as in
    test_torch_train_slice.py;
  * `eval_split`, `run_model` (a directory and an h5 split) and
    `extract_features` over inputs that hold one thin image, against the
    JAX package on the same checkpoint.
"""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from densecap_tpu.cli import extract_features as jax_extract
from densecap_tpu.cli import run_model as jax_run
from densecap_tpu.data.loader import DenseCapLoader as JaxLoader
from densecap_tpu.eval import evaluator as jax_evaluator
from densecap_tpu.eval.eval_split import eval_split as jax_eval_split
from densecap_tpu.models import densecap as jd
from densecap_tpu.ops.roi_align import roi_align as jax_roi_align
from densecap_tpu.utils import checkpoint as jax_ckpt
from densecap_tpu_torch.cli import extract_features, run_model
from densecap_tpu_torch.data.loader import DenseCapLoader
from densecap_tpu_torch.eval import evaluator
from densecap_tpu_torch.eval.eval_split import eval_split
from densecap_tpu_torch.ops.roi_align import roi_align
from densecap_tpu_torch.parallel.train_step import batched_loss
from densecap_tpu_torch.utils.checkpoint import to_torch
from test_torch_eval import make_dataset, tiny_configs
from test_torch_train_slice import (JCFG, LOSS_KEYS, PCFG, M, P, _flat,
                                    _grad_tree, _port_dbg, _torch_batch)

torch.set_num_threads(2)
ROI_TOL = 1e-6
TOL = 1e-4
HF = WF = 10


def _roi_case(fh, fw, seed, masked=True):
    """Features (1, HF, WF, 6), nine boxes on the image whose extent is
    (fh, fw), that image's size, and an upstream gradient."""
    rng = np.random.default_rng(seed)
    hs, ws = 16.0 * fh + 8, 16.0 * fw + 8
    feats = rng.standard_normal((1, HF, WF, 6)).astype(np.float32)
    if masked:
        feats[:, fh:] = 0
        feats[:, :, fw:] = 0
    xy = rng.uniform((1, 1), (ws, hs), (9, 2))
    wh = rng.uniform((2, 2), (ws * 1.5, hs * 1.5), (9, 2))
    boxes = np.concatenate([xy, wh], 1)[None].astype(np.float32)
    g = rng.standard_normal((1, 9, 7, 7, 6)).astype(np.float32)
    return feats, boxes, hs, ws, g


def _port_roi(feats, boxes, hs, ws, fh, fw, g):
    f = torch.from_numpy(feats).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    out = roi_align(f, b, torch.tensor([hs]), torch.tensor([ws]),
                    torch.tensor([fh]), torch.tensor([fw]), 7, 7)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy()[0], f.grad.numpy()[0], b.grad.numpy()[0]


def _jax_roi(feats, boxes, hs, ws, fh, fw, g):
    def loss(f, b):
        out = jax_roi_align(f, b, hs, ws, 7, 7, feat_h=fh, feat_w=fw)
        return jnp.sum(out * g[0]), out

    (_, out), (df, db) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(feats[0]), jnp.asarray(boxes[0]))
    return np.asarray(out), np.asarray(df), np.asarray(db)


def _close(got, ref, what, tol=ROI_TOL):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("fh,fw", [(0, 9), (9, 0), (0, 0), (1, 9), (9, 1),
                                   (1, 1)])
def test_roi_align_matches_jax_at_thin_extents(fh, fw):
    args = _roi_case(fh, fw, seed=10 * fh + fw)
    got = _port_roi(*args[:4], fh, fw, args[4])
    ref = _jax_roi(*args[:4], fh, fw, args[4])
    _close(got[0], ref[0], "forward")
    _close(got[2], ref[2], "d boxes")
    inside = np.zeros((HF, WF, 1), np.float32)
    inside[:fh, :fw] = 1
    _close(got[1] * inside, ref[1] * inside, "d feats inside the extent")
    if min(fh, fw) >= 1:  # the same cells on both sides
        _close(got[1], ref[1], "d feats")
    else:  # the whole scatter lands outside the extent on both sides
        assert not (got[1] * inside).any() and np.abs(got[1]).max() > 0
        assert not (got[0].any() or got[2].any())


@pytest.mark.parametrize("fh,fw", [(HF + 3, WF), (HF, WF + 3)],
                         ids=["oversized_h", "oversized_w"])
def test_roi_align_forward_clamps_oversized_extent_as_jax(fh, fw):
    feats, boxes, hs, ws, g = _roi_case(fh, fw, seed=fh + 2 * fw,
                                        masked=False)
    got = _port_roi(feats, boxes, hs, ws, fh, fw, g)[0]
    _close(got, _jax_roi(feats, boxes, hs, ws, fh, fw, g)[0], "forward",
           tol=1e-5)


THIN_HS, THIN_WS = np.float32([96, 96]), np.float32([80, 10])


@pytest.fixture(scope="module")
def thin_train():
    """The train slice's tiny setup with image 1 cut to 96x10 (feature
    extent 6x0) and its gt boxes inside those 10 columns."""
    params = jd.init_params(jax.random.PRNGKey(0), JCFG)
    for i, (a, b) in enumerate([("rpn", "box"), ("box_reg", None)]):
        leaf = params[a] if b is None else params[a][b]
        leaf["w"] = 0.01 * jax.random.normal(
            jax.random.PRNGKey(i + 1), leaf["w"].shape, jnp.float32)
    rng = np.random.default_rng(0)
    ims = (rng.standard_normal((2, 96, 96, 3)) * 30).astype(np.float32)
    for i in range(2):
        ims[i, int(THIN_HS[i]):] = 0
        ims[i, :, int(THIN_WS[i]):] = 0
    xy = rng.uniform(20, 70, (2, 6, 2))
    wh = rng.uniform(12, 40, (2, 6, 2))
    gt_boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    gt_boxes[1, :, 0], gt_boxes[1, :, 2] = 5.5, 8.0
    gt_labels = rng.integers(1, 21, (2, 6, 4)).astype(np.int32)
    gt_labels[:, :, 3] = 0
    gt_valid = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    dbg = {"pos": rng.permutation(P).astype(np.int32),
           "neg": rng.permutation(M).astype(np.int32)}
    batch = dict(image=ims, height=THIN_HS, width=THIN_WS,
                 gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid)

    def jax_losses(p):
        per = [jd.forward_train(
            p, jnp.asarray(ims[i]), jnp.asarray(THIN_HS[i]),
            jnp.asarray(THIN_WS[i]), jnp.asarray(gt_boxes[i]),
            jnp.asarray(gt_labels[i]), jnp.asarray(gt_valid[i]),
            jax.random.PRNGKey(i), JCFG,
            debug_sampler={k: jnp.asarray(v) for k, v in dbg.items()})
            for i in range(2)]
        losses = {k: (per[0][k] + per[1][k]) / 2.0 for k in per[0]}
        return losses["total_loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(
        jax_losses, has_aux=True))(params)
    return dict(np_params=jax.tree_util.tree_map(np.asarray, params),
                batch=batch, dbg=dbg, jax_losses=losses, jax_grads=grads)


def test_train_step_with_thin_frame_matches_jax(thin_train):
    model = to_torch(thin_train["np_params"], PCFG, "cpu", train=True)
    losses = batched_loss(model, _torch_batch(thin_train["batch"]),
                          debug_sampler=_port_dbg(thin_train["dbg"]))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k]),
                                   float(thin_train["jax_losses"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert all(np.isfinite(float(v)) for v in losses.values())
    losses["total_loss"].backward()
    got = _flat(_grad_tree(model))
    ref = _flat(thin_train["jax_grads"])
    for k in ref:
        if k.startswith("trunk1/"):
            continue
        scale = np.abs(ref[k]).max()
        assert scale > 0, f"{k}: reference gradient is all zero"
        err = np.abs(got[k] - ref[k]).max() / scale
        assert err <= 1e-3, f"{k}: relative gradient error {err:.2e}"


@pytest.fixture(scope="module")
def thin_data(tmp_path_factory):
    """The eval tests' tiny h5 with a 200x8 image in val, a checkpoint
    with its meta, and a directory of JPEGs holding a 600x20 frame."""
    root = make_dataset(tmp_path_factory.mktemp("torch_thin"), thin=True)
    loader = DenseCapLoader(root / "d.h5", root / "d.json", max_gt_boxes=4)
    jcfg, pcfg = tiny_configs(loader.vocab_size(), loader.seq_length(),
                              loader.canvas)
    meta = json.dumps({"vocab_size": jcfg.vocab_size,
                       "seq_length": jcfg.seq_length,
                       "idx_to_token": loader.info["idx_to_token"],
                       "config": jcfg.to_json()})
    assert int(loader.image_widths[2]) == 3  # 0 feature columns
    loader.close()
    params = jd.init_params(jax.random.PRNGKey(3), jcfg)
    jax_ckpt.save_params(str(root / "ck.npz"), params,
                         extra={"meta": meta})
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(72, 96), (600, 20), (96, 72)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(frames / f"f{i}.jpg")
    model = to_torch(jax.tree_util.tree_map(np.asarray, params), pcfg, "cpu")
    return dict(root=root, params=params, jcfg=jcfg, model=model)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_eval_split_with_thin_image_matches_jax(thin_data, batch_size,
                                                monkeypatch):
    root = thin_data["root"]
    counts = {}
    for tag, mod in (("jax", jax_evaluator), ("port", evaluator)):
        real = mod.DenseCaptioningEvaluator.add_result

        def add_result(self, scores, boxes, text, gt_boxes, gt_text,
                       tag=tag, real=real):
            counts.setdefault(tag, []).append((len(boxes), len(gt_boxes)))
            return real(self, scores, boxes, text, gt_boxes, gt_text)

        monkeypatch.setattr(mod.DenseCaptioningEvaluator, "add_result",
                            add_result)
    jloader = JaxLoader(str(root / "d.h5"), str(root / "d.json"),
                        max_gt_boxes=4)
    ref = jax_eval_split(thin_data["params"], jloader, thin_data["jcfg"],
                         split=1, verbose=False, compute_losses=False,
                         batch_size=batch_size)
    ploader = DenseCapLoader(root / "d.h5", root / "d.json", max_gt_boxes=4)
    got = eval_split(thin_data["model"], ploader, split=1, verbose=False,
                     compute_losses=False, batch_size=batch_size)
    ploader.close()
    # the thin image (second of val) has no detections; its 2 gt boxes
    # still count
    assert counts["port"] == counts["jax"]
    assert counts["port"][1] == (0, 2)
    assert all(n > 0 for i, (n, _) in enumerate(counts["port"]) if i != 1)
    for key in ("map", "detmap"):
        assert got["ap_results"][key] == pytest.approx(
            ref["ap_results"][key], rel=0, abs=1e-6)


def _results(path):
    with open(path) as f:
        return json.load(f)["results"]


@pytest.mark.parametrize("source", ["input_dir", "input_split"])
def test_run_model_with_thin_image_matches_jax(thin_data, tmp_path, source):
    root = thin_data["root"]
    if source == "input_dir":
        inputs = ["--input_dir", str(root / "frames")]
    else:
        inputs = ["--input_split", "val", "--data_h5", str(root / "d.h5"),
                  "--data_json", str(root / "d.json")]
    args = (["--checkpoint", str(root / "ck.npz"), "--image_size", "64",
             "--num_proposals", "10"] + inputs)
    jax_run.main(args + ["--output_dir", str(tmp_path / "jax"),
                         "--native_io", "0"])
    run_model.main(args + ["--output_dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    got = _results(tmp_path / "port" / "results.json")
    ref = _results(tmp_path / "jax" / "results.json")
    assert [r["img_name"] for r in got] == [r["img_name"] for r in ref]
    assert [len(r["boxes"]) > 0 for r in got] == [True, False, True] + [
        True] * (len(got) - 3)
    for g, r in zip(got, ref):
        assert g["captions"] == r["captions"]
        np.testing.assert_allclose(np.reshape(g["boxes"], (-1, 4)),
                                   np.reshape(r["boxes"], (-1, 4)),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=TOL,
                                   atol=TOL)


def test_extract_features_with_thin_image_matches_jax(thin_data, tmp_path):
    root = thin_data["root"]
    args = ["--checkpoint", str(root / "ck.npz"), "--input_dir",
            str(root / "frames"), "--image_size", "64",
            "--boxes_per_image", "6"]
    jax_extract.main(args + ["--output_h5", str(tmp_path / "jax.h5")])
    extract_features.main(args + ["--output_h5", str(tmp_path / "port.h5"),
                                  "--device", "cpu"])
    with h5py.File(tmp_path / "jax.h5") as ref, \
            h5py.File(tmp_path / "port.h5") as got:
        valid = got["valid"][:]
        np.testing.assert_array_equal(valid, ref["valid"][:])
        assert valid[0].any() and not valid[1].any() and valid[2].any()
        np.testing.assert_allclose(got["boxes"][:], ref["boxes"][:],
                                   rtol=TOL, atol=TOL)
        feats = ref["feats"][:]
        np.testing.assert_allclose(got["feats"][:], feats, rtol=TOL,
                                   atol=1e-5 * float(np.abs(feats).max()))
