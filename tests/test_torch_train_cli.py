"""The port's training CLI on the CPU over a tiny preprocessed dataset:
three iterations with the finetune flip at iteration 2, the written
checkpoint read back through the JAX package's `load_params`, and the NaN
watchdog. The CLI has no fc-width flag (the JAX CLI has none either), so
the test narrows fc6/fc7 to 64 by patching the config class it builds.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from densecap_tpu_torch.cli import train as train_cli
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.parallel import train_step
from densecap_tpu_torch.utils.checkpoint import init_params, to_torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image

    from densecap_tpu.data import preprocess as pp

    root = tmp_path_factory.mktemp("torch_cli_vg")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    data = []
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (72, 96, 3), dtype=np.uint8)
                        ).save(img_dir / f"{i + 1}.jpg")
        data.append({"id": i + 1, "regions": [
            {"phrase": "a red cat", "x": 8, "y": 8, "width": 30,
             "height": 24},
            {"phrase": "a blue dog", "x": 48, "y": 30, "width": 24,
             "height": 30},
        ]})
    with open(root / "regions.json", "w") as f:
        json.dump(data, f)
    with open(root / "splits.json", "w") as f:
        json.dump({"train": [1, 2, 3], "val": [4], "test": []}, f)
    pp.main(["--region_data", str(root / "regions.json"),
             "--image_dir", str(img_dir),
             "--split_json", str(root / "splits.json"),
             "--h5_output", str(root / "d.h5"),
             "--json_output", str(root / "d.json"),
             "--image_size", "64", "--max_token_length", "5",
             "--min_token_instances", "1", "--num_workers", "1"])
    return root


@pytest.fixture
def narrow_fc(monkeypatch):
    monkeypatch.setattr(train_cli, "DenseCapConfig",
                        functools.partial(DenseCapConfig, fc_dim=64))


def _args(dataset, prefix, iters):
    return ["--device", "cpu",
            "--data_h5", str(dataset / "d.h5"),
            "--data_json", str(dataset / "d.json"),
            "--batch_size", "2", "--max_gt_boxes", "4",
            "--sampler_batch_size", "8", "--rnn_size", "16",
            "--input_encoding_size", "16", "--learning_rate", "1e-4",
            "--max_iters", str(iters), "--save_checkpoint_every", "100",
            "--losses_log_every", "1", "--seed", "5",
            "--checkpoint_path", prefix]


def test_train_cli_three_iterations(dataset, tmp_path, narrow_fc):
    from densecap_tpu.config import DenseCapConfig as JaxConfig
    from densecap_tpu.utils import checkpoint as jax_ckpt

    prefix = str(tmp_path / "ck" / "densecap")
    train_cli.main(_args(dataset, prefix, 3) + ["--finetune_cnn_after", "2"])

    with open(prefix + ".json") as f:
        hist = json.load(f)
    assert hist["iter"] == 3
    assert sorted(map(int, hist["loss_history"])) == [1, 2, 3]
    assert all(np.isfinite(v["total_loss"])
               for v in hist["loss_history"].values())
    assert os.path.exists(prefix + ".optim.pt")

    params, extra = jax_ckpt.load_params(prefix + ".npz")
    meta = json.loads(str(extra["meta"]))
    cfg = JaxConfig.from_json(meta["config"])
    assert not cfg.static_freeze_cnn and cfg.fc_dim == 64
    assert params["lm"]["proj"]["w"].shape == (16, cfg.vocab_size + 1)
    assert set(meta["idx_to_token"].values()) >= {"cat", "dog"}

    # trunk1 never moves; trunk2 moved at the flip (iteration 3)
    pcfg = DenseCapConfig.from_json(meta["config"])
    init = init_params(pcfg, seed=5)
    for name, p in init["trunk1"].items():
        np.testing.assert_array_equal(params["trunk1"][name]["w"], p["w"])
    assert all(np.abs(params["trunk2"][n]["w"] - p["w"]).max() > 0
               for n, p in init["trunk2"].items())
    assert np.abs(params["recog"]["fc6"]["w"]
                  - init["recog"]["fc6"]["w"]).max() > 0
    to_torch(params, pcfg, "cpu")  # the port serves the checkpoint


def test_nan_watchdog_fires(dataset, tmp_path, narrow_fc, monkeypatch):
    real_step = train_step.Trainer.step

    def poisoned(self, *a, **kw):
        losses = real_step(self, *a, **kw)
        if self.count >= 2:  # NaN from iteration 2 on
            losses = dict(losses, total_loss=losses["total_loss"] * np.nan)
        return losses

    monkeypatch.setattr(train_step.Trainer, "step", poisoned)
    with pytest.raises(SystemExit, match="NaN at iter 2"):
        train_cli.main(_args(dataset, str(tmp_path / "ck" / "d"), 20))
