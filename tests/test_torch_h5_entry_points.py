"""The port's h5 entry points need no h5py: each runs in a fresh
interpreter where `import h5py` fails (`sys.modules["h5py"] = None`), on
the CPU, over a tiny h5 that the port's preprocess wrote:
`data.preprocess`, `cli.train` for 2 iterations (ending in its val
evaluation and checkpoint), `cli.evaluate_model`, `cli.run_model
--input_split` and `cli.extract_features`. Each must end with rc 0, and
what it wrote is read back here with h5py (the oracle)."""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
from PIL import Image

from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.data import preprocess as pp
from densecap_tpu_torch.utils.checkpoint import init_params, save_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(anchors=((10, 10), (20, 20), (14, 28), (28, 14)),
            test_max_proposals=10, rnn_size=24, rnn_encoding_size=24,
            fc_dim=48, rpn_num_filters=24, max_gt_boxes=4)
# the subprocess: h5py made unimportable, the train CLI's fc narrowed (it
# has no width flag), then the entry point's main
CODE = """\
import functools, sys
sys.modules["h5py"] = None
import torch
torch.set_num_threads(2)
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.cli import train
train.DenseCapConfig = functools.partial(DenseCapConfig, fc_dim=48)
import importlib
importlib.import_module({module!r}).main({argv!r})
assert sys.modules["h5py"] is None
"""


def _vg(root):
    """6 JPEGs of 72x96 / 96x72 with 2-3 captioned regions each, their
    regions.json and a split of 3 / 2 / 1."""
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    data = []
    for i in range(6):
        h, w = (96, 72) if i % 2 else (72, 96)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(img_dir / f"{i + 1}.jpg")
        data.append({"id": i + 1, "regions": [
            {"phrase": "a red cat", "x": 8, "y": 8, "width": 30,
             "height": 24},
            {"phrase": "a blue dog", "x": 30, "y": 30, "width": 24,
             "height": 30}] + ([{"phrase": "a tall tree", "x": 10, "y": 20,
                                 "width": 40, "height": 40}] if i % 2
                               else [])})
    (root / "regions.json").write_text(json.dumps(data))
    (root / "splits.json").write_text(json.dumps(
        {"train": [1, 2, 3], "val": [4, 5], "test": [6]}))
    return ["--region_data", str(root / "regions.json"),
            "--image_dir", str(img_dir),
            "--split_json", str(root / "splits.json"),
            "--image_size", "64", "--max_token_length", "5",
            "--min_token_instances", "1", "--num_workers", "1"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny h5 (the port's preprocess, here) and a tiny checkpoint
    with its meta."""
    root = tmp_path_factory.mktemp("torch_h5_entry")
    pp_args = _vg(root)
    pp.main(pp_args + ["--h5_output", str(root / "d.h5"),
                       "--json_output", str(root / "d.json")])
    info = json.loads((root / "d.json").read_text())
    with h5py.File(root / "d.h5", "r") as f:
        seq = f["labels"].shape[1]
    cfg = DenseCapConfig(**TINY, vocab_size=len(info["token_to_idx"]),
                         seq_length=seq, image_size=64)
    meta = json.dumps({"vocab_size": cfg.vocab_size, "seq_length": seq,
                       "idx_to_token": info["idx_to_token"],
                       "config": cfg.to_json()})
    save_params(str(root / "ck.npz"), init_params(cfg, seed=3),
                extra={"meta": meta})
    return root, pp_args


def _entry(setup, name, out):
    """(module, argv) of one entry point, writing under `out`."""
    root, pp_args = setup
    data = ["--data_h5", str(root / "d.h5"), "--data_json",
            str(root / "d.json")]
    ck = ["--checkpoint", str(root / "ck.npz")]
    return {
        "preprocess": ("densecap_tpu_torch.data.preprocess", pp_args + [
            "--h5_output", str(out / "p.h5"),
            "--json_output", str(out / "p.json")]),
        "train": ("densecap_tpu_torch.cli.train", data + [
            "--device", "cpu", "--batch_size", "2", "--max_gt_boxes", "4",
            "--sampler_batch_size", "8", "--rnn_size", "16",
            "--input_encoding_size", "16", "--max_iters", "2",
            "--save_checkpoint_every", "100", "--losses_log_every", "1",
            "--val_images_use", "2",
            "--checkpoint_path", str(out / "ck" / "densecap")]),
        "evaluate_model": ("densecap_tpu_torch.cli.evaluate_model", ck + data
                           + ["--split", "val", "--max_gt_boxes", "4",
                              "--num_proposals", "10", "--device", "cpu"]),
        "run_model": ("densecap_tpu_torch.cli.run_model", ck + data + [
            "--input_split", "val", "--image_size", "64",
            "--num_proposals", "10", "--output_dir", str(out / "vis"),
            "--device", "cpu"]),
        "extract_features": ("densecap_tpu_torch.cli.extract_features", ck + [
            "--input_dir", str(root / "images"), "--image_size", "64",
            "--boxes_per_image", "6", "--output_h5", str(out / "f.h5"),
            "--device", "cpu"]),
    }[name]


@pytest.mark.parametrize("name", ["preprocess", "train", "evaluate_model",
                                  "run_model", "extract_features"])
def test_entry_point_without_h5py(setup, tmp_path, name):
    module, argv = _entry(setup, name, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", CODE.format(module=module, argv=argv)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    if name == "preprocess":  # the same h5 as the one written with h5py
        with h5py.File(setup[0] / "d.h5", "r") as a, \
                h5py.File(tmp_path / "p.h5", "r") as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k][()], b[k][()])
    elif name == "train":
        assert "val mAP" in out
        assert (tmp_path / "ck" / "densecap.npz").exists()
        hist = json.loads((tmp_path / "ck" / "densecap.json").read_text())
        assert hist["iter"] == 2 and list(hist["loss_history"]) == ["1", "2"]
    elif name == "evaluate_model":
        res = json.loads(out.strip().splitlines()[-1])
        assert np.isfinite(res["map"]) and np.isfinite(res["loss"])
    elif name == "run_model":
        results = json.loads((tmp_path / "vis" / "results.json").read_text())
        assert len(results["results"]) == 2
    else:
        with h5py.File(tmp_path / "f.h5", "r") as f:
            assert f["feats"].shape == (6, 6, 48)
            assert f["valid"].dtype == np.bool_ and f["valid"][()].any()
            assert [p.decode() for p in f["paths"][()]] == [
                str(setup[0] / "images" / f"{i}.jpg") for i in range(1, 7)]
