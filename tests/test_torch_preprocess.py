"""The port's Visual Genome preprocessing (`data/preprocess.py`) against
the JAX package's: both run on one synthetic mini VG (6 images, a split
file, a caption past the length limit, rare words that become <UNK>),
and every h5 dataset (name, dtype, shape, values) and the dicts json
are equal; the port's loader reads the port's h5."""

import json

import h5py
import numpy as np
import pytest
from PIL import Image

from densecap_tpu.data import preprocess as jax_pp
from densecap_tpu_torch.data import preprocess as pp
from densecap_tpu_torch.data.loader import DenseCapLoader


@pytest.fixture(scope="module")
def mini_vg(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mini_vg")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    phrases = ["a red cat sitting", "the Big--- DOG!", "a red dog",
               "½ of a café…", "the cat", " ".join(["word"] * 30)]
    data = []
    for i in range(6):
        img_id = 200 + i
        h, w = (96 + 8 * i, 128) if i % 2 else (128, 80 + 6 * i)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(img_dir / f"{img_id}.jpg")
        data.append({"id": img_id, "regions": [
            {"phrase": phrases[(i + j) % len(phrases)], "x": 3 + 7 * j,
             "y": 5 + 9 * j, "width": 20 + 11 * j, "height": 30 + 5 * j}
            for j in range(2 + i % 3)] + [
            {"phrase": f"a rare{i} dog", "x": 40, "y": 2, "width": 12,
             "height": 9}]})
    (root / "regions.json").write_text(json.dumps(data))
    (root / "splits.json").write_text(json.dumps(
        {"train": [200, 201, 202], "val": [203, 204], "test": [205]}))
    return root


def _run(module, root, tag):
    h5_out, json_out = root / f"{tag}.h5", root / f"{tag}.json"
    module.main(["--region_data", str(root / "regions.json"),
                 "--image_dir", str(root / "images"),
                 "--split_json", str(root / "splits.json"),
                 "--h5_output", str(h5_out), "--json_output", str(json_out),
                 "--image_size", "64", "--max_token_length", "6",
                 "--min_token_instances", "2", "--num_workers", "2"])
    return h5_out, json_out


def test_preprocess_matches_jax(mini_vg):
    ref_h5, ref_json = _run(jax_pp, mini_vg, "jax")
    got_h5, got_json = _run(pp, mini_vg, "port")
    with h5py.File(ref_h5) as a, h5py.File(got_h5) as b:
        assert sorted(a) == sorted(b)
        assert len(a["images"]) == 6 and len(a["boxes"]) > 6
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k][()], b[k][()])
    ref = json.loads(ref_json.read_text())
    got = json.loads(got_json.read_text())
    assert got == ref
    assert "<UNK>" in got["token_to_idx"]

    loader = DenseCapLoader(got_h5, got_json, max_gt_boxes=4)
    try:
        assert [loader.split_size(s) for s in (0, 1, 2)] == [3, 2, 1]
        ex = loader.get_example(split=1)
        assert ex["image"].shape == (64, 64, 3)
        assert ex["image"].dtype == np.uint8
        assert loader.idx_to_token() == {int(k): v for k, v in
                                         ref["idx_to_token"].items()}
    finally:
        loader.close()


def test_words_and_boxes_match_jax():
    for phrase in ("The Big--- DOG!", "½ of it… é", "a™ 5¢ ç û°"):
        assert pp.words_preprocess(phrase) == jax_pp.words_preprocess(phrase)
    data = [{"regions": [{"x": x, "y": y, "width": w, "height": h,
                          "tokens": ["a"]}
                         for x, y, w, h in ((1, 1, 10, 10), (90, 5, 50, 7),
                                            (0, 0, 500, 500),
                                            (33, 61, 1, 1))]}]
    for H, W in ((100, 120), (480, 640)):
        np.testing.assert_array_equal(
            pp.encode_boxes(data, [H], [W], 64),
            jax_pp.encode_boxes(data, [H], [W], 64))
