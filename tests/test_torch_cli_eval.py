"""The port's inference and evaluation CLIs against the JAX package's, on
one tiny checkpoint written with its `meta` (config and vocabulary), and
the validation gate of the port's train CLI.

  * `run_model` over a directory of JPEGs and over the h5's val split:
    the same images, captions equal, boxes and scores within 1e-4
    (relative and absolute);
  * `extract_features`: `valid` and `paths` equal, boxes within 1e-4,
    codes within 1e-4 relative plus 1e-5 of their largest magnitude
    (fc6's summation order, as in test_torch_extract_features.py);
  * `evaluate_model`: map and detmap within 1e-6;
  * the train CLI evaluates at every interval, keeps `results_history`,
    and writes the `.npz` only when val mAP improves;
  * `--quantize int8` on `run_model`, `extract_features` and
    `evaluate_model` against the JAX CLIs with the same flag, to the same
    tolerances, on a checkpoint whose trunk passes its input through
    (`test_torch_quant.py`: last-bit feature differences would otherwise
    flip a few int8 codes).

Every port CLI runs with `--device cpu`; the JAX CLIs on the PIL path
(`--native_io 0`).
"""

import functools
import json

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from densecap_tpu.cli import evaluate_model as jax_evaluate
from densecap_tpu.cli import extract_features as jax_extract
from densecap_tpu.cli import run_model as jax_run
from densecap_tpu.models import densecap as jd
from densecap_tpu.utils import checkpoint as jax_ckpt
from densecap_tpu_torch.cli import evaluate_model, extract_features, run_model
from densecap_tpu_torch.cli import train as train_cli
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.data.loader import DenseCapLoader
from test_torch_eval import make_dataset, tiny_configs
from test_torch_quant import _pass_through_trunk

torch.set_num_threads(2)
TOL = 1e-4
COMMON = ["--image_size", "64", "--num_proposals", "10"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = make_dataset(tmp_path_factory.mktemp("torch_cli_eval"))
    loader = DenseCapLoader(root / "d.h5", root / "d.json", max_gt_boxes=4)
    jcfg, _ = tiny_configs(loader.vocab_size(), loader.seq_length(),
                           loader.canvas)
    meta = json.dumps({"vocab_size": jcfg.vocab_size,
                       "seq_length": jcfg.seq_length,
                       "idx_to_token": loader.info["idx_to_token"],
                       "config": jcfg.to_json()})
    loader.close()
    params = jd.init_params(jax.random.PRNGKey(3), jcfg)
    jax_ckpt.save_params(str(root / "ck.npz"), params, extra={"meta": meta})
    jax_ckpt.save_params(str(root / "ck_int8.npz"),
                         _pass_through_trunk(params), extra={"meta": meta})
    # a second directory, of the images at other sizes
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(72, 96), (96, 72), (50, 50), (130, 80)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(frames / f"f{i}.jpg")
    return root


@pytest.fixture(autouse=True)
def no_jax_cache(monkeypatch):
    monkeypatch.setenv("DENSECAP_NO_COMPILATION_CACHE", "1")


def _results(path):
    with open(path) as f:
        return json.load(f)["results"]


def _same_results(got, ref):
    assert [r["img_name"] for r in got] == [r["img_name"] for r in ref]
    for g, r in zip(got, ref):
        assert g["captions"] == r["captions"]
        assert len(g["captions"]) > 0
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("source", ["input_dir", "input_split"])
def test_run_model_matches_jax(setup, tmp_path, source):
    if source == "input_dir":
        inputs = ["--input_dir", str(setup / "frames")]
    else:
        inputs = ["--input_split", "val", "--data_h5", str(setup / "d.h5"),
                  "--data_json", str(setup / "d.json")]
    args = ["--checkpoint", str(setup / "ck.npz")] + inputs + COMMON
    jax_run.main(args + ["--output_dir", str(tmp_path / "jax"),
                         "--native_io", "0"])
    run_model.main(args + ["--output_dir", str(tmp_path / "port"),
                           "--device", "cpu", "--output_images", "1",
                           "--copy_images", "1"])
    got = _results(tmp_path / "port" / "results.json")
    _same_results(got, _results(tmp_path / "jax" / "results.json"))
    if source == "input_dir":
        assert len(got) == 4
        for name in ("f1_boxes.png", "f1.jpg"):
            assert (tmp_path / "port" / name).exists()


def test_extract_features_matches_jax(setup, tmp_path):
    args = ["--checkpoint", str(setup / "ck.npz"), "--input_dir",
            str(setup / "frames"), "--image_size", "64",
            "--boxes_per_image", "6"]
    jax_extract.main(args + ["--output_h5", str(tmp_path / "jax.h5")])
    extract_features.main(args + ["--output_h5", str(tmp_path / "port.h5"),
                                  "--device", "cpu"])
    with h5py.File(tmp_path / "jax.h5") as ref, \
            h5py.File(tmp_path / "port.h5") as got:
        assert got["boxes"].shape == (4, 6, 4)
        np.testing.assert_array_equal(got["valid"][:], ref["valid"][:])
        np.testing.assert_array_equal(got["paths"][:], ref["paths"][:])
        np.testing.assert_allclose(got["boxes"][:], ref["boxes"][:],
                                   rtol=TOL, atol=TOL)
        feats = ref["feats"][:]
        np.testing.assert_allclose(got["feats"][:], feats, rtol=TOL,
                                   atol=1e-5 * float(np.abs(feats).max()))


def test_evaluate_model_matches_jax(setup, capsys):
    args = ["--checkpoint", str(setup / "ck.npz"), "--data_h5",
            str(setup / "d.h5"), "--data_json", str(setup / "d.json"),
            "--split", "val", "--max_gt_boxes", "4", "--num_proposals", "10"]
    jax_evaluate.main(args + ["--skip_losses", "1"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate_model.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == ref.keys()
    assert got["score_method"] == ref["score_method"] == "fallback"
    for key in ("map", "detmap"):
        assert got[key] == pytest.approx(ref[key], rel=0, abs=1e-6)
    assert np.isfinite(got["loss"])


def test_run_model_int8_matches_jax(setup, tmp_path):
    args = ["--checkpoint", str(setup / "ck_int8.npz"), "--input_dir",
            str(setup / "frames"), "--quantize", "int8"] + COMMON
    jax_run.main(args + ["--output_dir", str(tmp_path / "jax")])
    run_model.main(args + ["--output_dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    got = _results(tmp_path / "port" / "results.json")
    assert len(got) == 4
    _same_results(got, _results(tmp_path / "jax" / "results.json"))


def test_extract_features_int8_matches_jax(setup, tmp_path):
    args = ["--checkpoint", str(setup / "ck_int8.npz"), "--input_dir",
            str(setup / "frames"), "--image_size", "64",
            "--boxes_per_image", "6", "--quantize", "int8"]
    jax_extract.main(args + ["--output_h5", str(tmp_path / "jax.h5")])
    extract_features.main(args + ["--output_h5", str(tmp_path / "port.h5"),
                                  "--device", "cpu"])
    with h5py.File(tmp_path / "jax.h5") as ref, \
            h5py.File(tmp_path / "port.h5") as got:
        np.testing.assert_array_equal(got["valid"][:], ref["valid"][:])
        assert got["valid"][:].any()
        np.testing.assert_allclose(got["boxes"][:], ref["boxes"][:],
                                   rtol=TOL, atol=TOL)
        feats = ref["feats"][:]
        np.testing.assert_allclose(got["feats"][:], feats, rtol=TOL,
                                   atol=1e-5 * float(np.abs(feats).max()))


def test_evaluate_model_int8_matches_jax(setup, capsys):
    # the loss pass trains through fc6/fc7, which int8 refuses in both
    args = ["--checkpoint", str(setup / "ck_int8.npz"), "--data_h5",
            str(setup / "d.h5"), "--data_json", str(setup / "d.json"),
            "--split", "val", "--max_gt_boxes", "4", "--num_proposals", "10",
            "--quantize", "int8", "--skip_losses", "1"]
    jax_evaluate.main(args)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate_model.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("map", "detmap"):
        assert got[key] == pytest.approx(ref[key], rel=0, abs=1e-6)
    assert got["loss"] is None and ref["loss"] is None


def test_train_cli_saves_only_when_val_map_improves(setup, tmp_path,
                                                     monkeypatch):
    maps = iter([0.1, 0.05, 0.2, 0.2])
    saved = []
    real_save = train_cli.save_checkpoint
    monkeypatch.setattr(train_cli, "DenseCapConfig",
                        functools.partial(DenseCapConfig, fc_dim=48))
    monkeypatch.setattr(
        train_cli, "eval_split", lambda model, loader, **kw: {
            "loss_results": {"total_loss": 1.0},
            "ap_results": {"map": next(maps)}})
    monkeypatch.setattr(
        train_cli, "save_checkpoint",
        lambda args, trainer, it, meta, **kw: (
            saved.append(it), real_save(args, trainer, it, meta, **kw)))
    prefix = str(tmp_path / "ck" / "densecap")
    train_cli.main(["--device", "cpu", "--data_h5", str(setup / "d.h5"),
                    "--data_json", str(setup / "d.json"),
                    "--batch_size", "1", "--max_gt_boxes", "4",
                    "--sampler_batch_size", "8", "--rnn_size", "16",
                    "--input_encoding_size", "16", "--max_iters", "4",
                    "--save_checkpoint_every", "1", "--losses_log_every", "1",
                    "--checkpoint_path", prefix])
    assert saved == [1, 3]
    with open(prefix + ".json") as f:
        hist = json.load(f)
    assert hist["iter"] == 4
    assert {int(k): v["map"] for k, v in hist["results_history"].items()} \
        == {1: 0.1, 2: 0.05, 3: 0.2, 4: 0.2}
    assert torch.load(prefix + ".optim.pt")["iter"] == 3
    params, _ = jax_ckpt.load_params(prefix + ".npz")
    assert params["recog"]["fc6"]["w"].shape[1] == 48
