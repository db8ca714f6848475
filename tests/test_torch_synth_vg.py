"""`scripts/torch_make_synth_vg.py` against `scripts/make_synth_vg.py`:
`make_scene` gives byte-equal images and equal regions from one seed,
scene after scene; and the two scripts, run at a small size, write the
same JPEGs, regions.json and splits.json, and h5 files (the JAX one by
h5py, the port's by its codec) that h5py reads equal."""

import json
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))

import make_synth_vg as jax_synth  # noqa: E402
import torch_make_synth_vg as synth  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_scene_matches_jax(seed):
    a, b = np.random.RandomState(seed), np.random.RandomState(seed)
    for W, H in ((800, 600), (600, 800), (768, 768), (800, 600)):
        n = int(a.randint(32, 49))
        assert n == int(b.randint(32, 49))
        img_a, reg_a = jax_synth.make_scene(a, W, H, n)
        img_b, reg_b = synth.make_scene(b, W, H, n)
        assert img_a.dtype == img_b.dtype == np.uint8
        assert img_a.tobytes() == img_b.tobytes()
        assert reg_a == reg_b
    assert a.randint(2**31) == b.randint(2**31)  # the streams stay in step


def test_dataset_matches_jax_script(tmp_path, monkeypatch):
    args = ["--n_portrait", "2", "--n_landscape", "1", "--n_square", "1",
            "--regions_per_image", "12", "--image_size", "64"]
    monkeypatch.setattr(sys, "argv", ["make_synth_vg.py", "--out_dir",
                                      str(tmp_path / "jax")] + args)
    jax_synth.main()
    synth.main(["--out_dir", str(tmp_path / "port"), "--num_workers", "2"]
               + args)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for name in ("regions.json", "splits.json"):
        assert json.loads((jax_dir / name).read_text()) == json.loads(
            (port_dir / name).read_text())
    jpgs = sorted(p.name for p in (jax_dir / "images").iterdir())
    assert jpgs == sorted(p.name for p in (port_dir / "images").iterdir())
    assert len(jpgs) == 4
    for name in jpgs:
        assert (jax_dir / "images" / name).read_bytes() == (
            port_dir / "images" / name).read_bytes()
    with h5py.File(jax_dir / "VG-regions.h5", "r") as a, \
            h5py.File(port_dir / "VG-regions.h5", "r") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k][()], b[k][()])
    assert json.loads((jax_dir / "VG-regions-dicts.json").read_text()) == \
        json.loads((port_dir / "VG-regions-dicts.json").read_text())
