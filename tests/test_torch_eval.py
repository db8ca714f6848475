"""The port's evaluation path against the JAX package's.

  * `DenseCaptioningEvaluator` on randomised detections and ground truth:
    AP dicts equal to the JAX evaluator's numpy branch (float64, 1e-12);
  * `merge_boxes` groups equal to the JAX version's (float64 there under
    the test conftest's x64);
  * the fallback caption scorer equal;
  * the METEOR jar under `<repo>/eval/meteor/` is found from any working
    directory (the JAX scorer looks relative to the current one);
  * `eval_split` against the JAX `eval_split` on a tiny preprocessed h5,
    at batch 1 and 2 without the loss pass: map and detmap within 1e-6;
    with the loss pass the JAX loss keys, all finite; a canvas cropped to
    a bucket gives the same detections as the square one.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.data.loader import DenseCapLoader as JaxLoader
from densecap_tpu.eval import evaluator as jax_evaluator
from densecap_tpu.eval import meteor as jax_meteor
from densecap_tpu.eval.eval_split import eval_split as jax_eval_split
from densecap_tpu.models import densecap as jd
from densecap_tpu.ops import boxes as jax_boxes
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.data.loader import DenseCapLoader
from densecap_tpu_torch.eval import evaluator, meteor
from densecap_tpu_torch.eval.eval_split import eval_split
from densecap_tpu_torch.ops.boxes import merge_boxes
from densecap_tpu_torch.utils.checkpoint import to_torch
from densecap_tpu_torch.utils.image import parse_buckets

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "red", "cat", "blue", "dog", "tree", "tall", "man"]


def make_dataset(root, thin=False):
    """A preprocessed h5 + dicts json under `root`: 6 images (4 of
    72x96, 2 of 96x72) on a 64 px canvas, split 1 / 5 / 0, with two or
    three captioned regions each. With `thin`, image 3 (in val) is 200x8
    instead, 64x3 on the canvas: a feature extent of 0 columns, with its
    regions inside the frame."""
    from PIL import Image

    from densecap_tpu.data import preprocess as pp

    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    data = []
    for i in range(6):
        h, w = (96, 72) if i in (2, 4) else (72, 96)
        if thin and i == 2:
            h, w = 200, 8
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(img_dir / f"{i + 1}.jpg")
        regions = [{"phrase": "a red cat", "x": 8, "y": 8, "width": 30,
                    "height": 24},
                   {"phrase": "a blue dog", "x": 30, "y": 30, "width": 24,
                    "height": 30}]
        if thin and i == 2:
            regions = [{"phrase": "a red cat", "x": 2, "y": 8, "width": 5,
                        "height": 60},
                       {"phrase": "a blue dog", "x": 1, "y": 100, "width": 7,
                        "height": 50}]
        if i % 2:
            regions.append({"phrase": "a tall tree", "x": 10, "y": 20,
                            "width": 40, "height": 40})
        data.append({"id": i + 1, "regions": regions})
    with open(root / "regions.json", "w") as f:
        json.dump(data, f)
    with open(root / "splits.json", "w") as f:
        json.dump({"train": [1], "val": [2, 3, 4, 5, 6], "test": []}, f)
    pp.main(["--region_data", str(root / "regions.json"),
             "--image_dir", str(img_dir),
             "--split_json", str(root / "splits.json"),
             "--h5_output", str(root / "d.h5"),
             "--json_output", str(root / "d.json"),
             "--image_size", "64", "--max_token_length", "5",
             "--min_token_instances", "1", "--num_workers", "1"])
    return root


TINY = dict(anchors=((10, 10), (20, 20), (14, 28), (28, 14)),
            test_max_proposals=10, rnn_size=24, rnn_encoding_size=24,
            fc_dim=48, rpn_num_filters=24, max_gt_boxes=4)


def tiny_configs(vocab_size, seq_length, canvas):
    kw = dict(TINY, vocab_size=vocab_size, seq_length=seq_length,
              image_size=canvas)
    return (JaxConfig(**kw, compute_dtype=jnp.float32),
            DenseCapConfig(**kw, compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("torch_eval_vg"))


@pytest.fixture(scope="module")
def models(dataset):
    loader = DenseCapLoader(dataset / "d.h5", dataset / "d.json",
                            max_gt_boxes=4)
    jcfg, pcfg = tiny_configs(loader.vocab_size(), loader.seq_length(),
                              loader.canvas)
    loader.close()
    params = jd.init_params(jax.random.PRNGKey(3), jcfg)
    model = to_torch(jax.tree_util.tree_map(np.asarray, params), pcfg, "cpu")
    return params, jcfg, model


def _random_image(rng):
    n, m = rng.integers(0, 12), rng.integers(0, 6)
    xy = rng.uniform(1, 100, (n, 2))
    gxy = rng.uniform(1, 100, (m, 2))
    if m and n:  # some detections near ground truth, some duplicated
        near = rng.integers(0, m, n // 2)
        xy[:n // 2] = gxy[near] + rng.normal(0, 3, (n // 2, 2))
    boxes = np.concatenate([xy, rng.uniform(5, 40, (n, 2))], 1)
    gt = np.concatenate([gxy, rng.uniform(5, 40, (m, 2))], 1)
    if m > 1:
        gt[1] = gt[0] + [1, 1, 0, 0]  # merged at IoU >= 0.7
    cap = lambda: " ".join(rng.choice(WORDS, rng.integers(1, 4)))
    scores = np.round(rng.normal(0, 1, n), 1)  # ties in objectness
    return scores, boxes, [cap() for _ in range(n)], gt, \
        [cap() for _ in range(m)]


def test_evaluator_matches_jax(monkeypatch):
    from densecap_tpu import native_lib
    from densecap_tpu_torch import native_lib as port_native_lib

    # both evaluators' numpy branches (test_torch_native.py holds the
    # port's libdcgeom branch against its numpy one)
    monkeypatch.setattr(native_lib, "is_available", lambda name: False)
    monkeypatch.setattr(port_native_lib, "is_available", lambda name: False)
    rng = np.random.default_rng(0)
    ours = evaluator.DenseCaptioningEvaluator()
    ref = jax_evaluator.DenseCaptioningEvaluator()
    for _ in range(25):
        args = _random_image(rng)
        ours.add_result(*args)
        ref.add_result(*args)
    a, b = ours.evaluate(), ref.evaluate()
    assert ours.records == ref.records
    assert a.keys() == b.keys() and a["score_method"] == b["score_method"]
    for key in ("map", "detmap"):
        assert a[key] == pytest.approx(b[key], rel=0, abs=1e-12)
    for key in ("ap_breakdown", "det_breakdown"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert a[key][k] == pytest.approx(b[key][k], rel=0, abs=1e-12)
    assert 0 < a["map"] < 1 and 0 < a["detmap"] < 1


def test_merge_boxes_matches_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 30):
        xy = rng.uniform(1, 60, (n, 2))
        b = np.concatenate([xy, xy + rng.uniform(2, 30, (n, 2))], 1)
        b[n // 2:] = np.round(b[n // 2:])  # integer boxes: exact IoU ties
        ours = merge_boxes(b, 0.7)
        ref = jax_boxes.merge_boxes(b, 0.7)
        assert len(ours) == len(ref)
        for g, r in zip(ours, ref):
            np.testing.assert_array_equal(g, np.asarray(r))


def test_fallback_scorer_matches_jax():
    rng = np.random.default_rng(2)
    records = [{"candidate": " ".join(rng.choice(WORDS, rng.integers(0, 5))),
                "references": [" ".join(rng.choice(WORDS, rng.integers(0, 5)))
                               for _ in range(rng.integers(0, 4))]}
               for _ in range(200)]
    assert (meteor.score_captions_fallback(records)
            == jax_meteor.score_captions_fallback(records))


FAKE_METEOR = """
import sys
for line in sys.stdin:
    if line.startswith("SCORE |||"):
        *refs, hyp = [f.strip() for f in line.split("|||")[1:]]
        print(f"stats {float(hyp in refs)}", flush=True)
    elif line.startswith("EVAL |||"):
        print(line.split("|||")[1].split()[1], flush=True)
"""


def test_meteor_jar_found_from_any_directory(tmp_path, monkeypatch):
    """A jar under the repository's eval/meteor/ is used whatever the
    working directory (here a stand-in repository root)."""
    assert meteor.REPO_ROOT == ROOT
    repo = tmp_path / "repo"
    (repo / "eval" / "meteor").mkdir(parents=True)
    (repo / "eval" / "meteor" / "meteor-1.5.jar").write_text("fake")
    script = tmp_path / "fake_meteor.py"
    script.write_text(FAKE_METEOR)
    monkeypatch.setattr(meteor, "REPO_ROOT", str(repo))
    monkeypatch.setattr(meteor.shutil, "which", lambda name: "/bin/" + name)
    monkeypatch.setattr(meteor, "_meteor_cmd",
                        lambda jar: [sys.executable, str(script)])
    records = [{"candidate": "a red cat", "references": ["a red cat"]},
               {"candidate": "a dog", "references": ["a tree"]}]
    for cwd in (tmp_path, repo / "eval"):
        monkeypatch.chdir(cwd)
        out = meteor.score_captions(records)
        assert out == {"scores": [1.0, 0.0], "method": "meteor"}


def _loaders(dataset):
    return (JaxLoader(str(dataset / "d.h5"), str(dataset / "d.json"),
                      max_gt_boxes=4),
            DenseCapLoader(dataset / "d.h5", dataset / "d.json",
                           max_gt_boxes=4))


@pytest.mark.parametrize("batch_size", [1, 2])
def test_eval_split_matches_jax(dataset, models, batch_size):
    params, jcfg, model = models
    jloader, ploader = _loaders(dataset)
    ref = jax_eval_split(params, jloader, jcfg, split=1, verbose=False,
                         compute_losses=False, batch_size=batch_size)
    got = eval_split(model, ploader, split=1, verbose=False,
                     compute_losses=False, batch_size=batch_size)
    ploader.close()
    for key in ("map", "detmap"):
        assert got["ap_results"][key] == pytest.approx(
            ref["ap_results"][key], rel=0, abs=1e-6)
    assert got["ap_results"]["detmap"] > 0


def test_eval_split_loss_pass(dataset, models):
    params, jcfg, model = models
    jloader, ploader = _loaders(dataset)
    ref = jax_eval_split(params, jloader, jcfg, split=1, max_images=1,
                         verbose=False)
    got = eval_split(model, ploader, split=1, max_images=2, verbose=False,
                     loss_generator=torch.Generator().manual_seed(1))
    ploader.close()
    assert got["loss_results"].keys() == ref["loss_results"].keys()
    assert all(np.isfinite(v) for v in got["loss_results"].values())


def test_eval_split_canvas_buckets(dataset, models, monkeypatch):
    """72x96 frames fill 48x64 of the 64 px canvas and 96x72 ones 64x48:
    batches of two crop to 48x64, 64x48 or stay square, and every image's
    detections equal the square canvas's."""
    _, _, model = models
    seen = {}
    real = evaluator.DenseCaptioningEvaluator.add_result

    def record(tag):
        def add_result(self, scores, boxes, text, *gt):
            seen.setdefault(tag, []).append((scores, boxes, text))
            return real(self, scores, boxes, text, *gt)
        return add_result

    shapes = []
    real_fwd = type(model).forward_test_batch

    def fwd(self, images, *a, **kw):
        shapes.append(tuple(images.shape[1:3]))
        return real_fwd(self, images, *a, **kw)

    monkeypatch.setattr(type(model), "forward_test_batch", fwd)
    ploader = _loaders(dataset)[1]
    for tag, buckets in (("square", None),
                         ("buckets", parse_buckets("48x64,64x48", 64))):
        monkeypatch.setattr(evaluator.DenseCaptioningEvaluator, "add_result",
                            record(tag))
        eval_split(model, ploader, split=1, verbose=False, batch_size=2,
                   canvas_buckets=buckets)
    ploader.close()
    assert set(shapes) == {(64, 64), (48, 64)}
    assert len(seen["square"]) == len(seen["buckets"]) == 5
    for (s0, b0, t0), (s1, b1, t1) in zip(seen["square"], seen["buckets"]):
        assert t0 == t1
        np.testing.assert_allclose(s0, s1, atol=1e-4)
        np.testing.assert_allclose(b0, b1, atol=1e-3)
