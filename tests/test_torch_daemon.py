"""The port's directory-watching daemon against the JAX package's.

Both daemons run their `main` on copies of one input directory (two
JPEGs, a PNG, a .txt and a truncated JPEG) with the same checkpoint and
flags, until their first scan that answers nothing, where the test stops
them at the poll sleep. The port's JSONs must equal the JAX daemon's
(which writes `engine.process_array`'s dicts): captions and ids exact,
boxes and scores within 1e-4 (conv accumulation orders differ). Each
answered input is deleted, the truncated JPEG and the .txt stay, and no
`.tmp` is left. With `--quantize int8` the checkpoint's trunk passes its
input through unchanged (see `test_torch_quant.py`: otherwise last-bit
feature differences flip a few int8 codes) and the same must hold.
`scan_once` is also driven on its own, on a model built in the test.
"""

import json
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.serve import daemon as jax_daemon
from densecap_tpu.utils import checkpoint as jax_ckpt
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.serve import daemon
from densecap_tpu_torch.serve.engine import InferenceEngine
from test_torch_quant import _pass_through_trunk

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(vocab_size=12, seq_length=4, image_size=64,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=8, rnn_size=16, rnn_encoding_size=16,
            fc_dim=32, rpn_num_filters=16)
JCFG = JaxConfig(**TINY, sampler_batch_size=8, max_gt_boxes=4,
                 compute_dtype=jnp.float32)
IDX_TO_TOKEN = {str(i): f"w{i}" for i in range(1, 13)}
FLAGS = ["--image_size", "64", "--num_proposals", "8", "--max_boxes", "5"]
ANSWERED = ["a.jpg", "b.JPEG", "c.png"]
LEFT = ["notes.txt", "partial.jpg"]


class _Stop(Exception):
    pass


def _stop_sleep(monkeypatch):
    def stop(_):
        raise _Stop
    monkeypatch.setattr(time, "sleep", stop)


def _inputs(path):
    path.mkdir()
    rng = np.random.default_rng(1)
    for name, hw in zip(ANSWERED, [(80, 100), (64, 48), (50, 70)]):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            path / name, format="PNG" if name.endswith("png") else "JPEG")
    (path / "notes.txt").write_text("not an image")
    full = (path / "a.jpg").read_bytes()
    (path / "partial.jpg").write_bytes(full[:len(full) // 3])
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_daemon")
    params = jd.init_params(jax.random.PRNGKey(0), JCFG)
    meta = json.dumps({"vocab_size": JCFG.vocab_size,
                       "seq_length": JCFG.seq_length,
                       "idx_to_token": IDX_TO_TOKEN,
                       "config": JCFG.to_json()})
    out = {}
    for kind, p in (("", params), ("int8", _pass_through_trunk(params))):
        out[kind] = root / f"ck{kind}.npz"
        jax_ckpt.save_params(str(out[kind]), p, extra={"meta": meta})
    return out


def _run(main, ck, src, dst, flags):
    with pytest.raises(_Stop):
        main(["--checkpoint", str(ck), "--input_dir", str(src),
              "--output_dir", str(dst)] + FLAGS + flags)


@pytest.mark.parametrize("quantize", ["", "int8"], ids=["bf16_path", "int8"])
def test_daemon_matches_jax_daemon(checkpoints, tmp_path, monkeypatch,
                                   quantize):
    monkeypatch.setenv("DENSECAP_NO_COMPILATION_CACHE", "1")
    _stop_sleep(monkeypatch)
    src = _inputs(tmp_path / "in")
    shutil.copytree(src, tmp_path / "in_jax")
    flags = ["--quantize", quantize] if quantize else []
    _run(jax_daemon.main, checkpoints[quantize], tmp_path / "in_jax",
         tmp_path / "out_jax", flags)
    _run(daemon.main, checkpoints[quantize], src, tmp_path / "out",
         flags + ["--device", "cpu"])
    for d in ("in", "in_jax"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == LEFT
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == ["a.json", "b.json", "c.json"]
    assert names == sorted(p.name for p in (tmp_path / "out_jax").iterdir())
    for name in names:
        got = json.loads((tmp_path / "out" / name).read_text())
        ref = json.loads((tmp_path / "out_jax" / name).read_text())
        assert set(got) == {"boxes", "scores", "captions", "ids"}
        assert 0 < len(got["boxes"]) <= 5
        assert got["captions"] == ref["captions"]
        assert got["ids"] == ref["ids"]
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=TOL,
                                   atol=TOL)


def test_scan_once_contract(tmp_path):
    params = jax.tree_util.tree_map(
        np.asarray, jd.init_params(jax.random.PRNGKey(2), JCFG))
    cfg = DenseCapConfig(**TINY, compute_dtype=torch.float32)
    engine = InferenceEngine(params, cfg, IDX_TO_TOKEN, device="cpu",
                             max_boxes=5)
    src = _inputs(tmp_path / "in")
    out = tmp_path / "out"
    out.mkdir()
    assert daemon.scan_once(engine, str(src), str(out)) == 3
    assert sorted(p.name for p in src.iterdir()) == LEFT
    assert sorted(p.name for p in out.iterdir()) == [
        "a.json", "b.json", "c.json"]
    # nothing left to answer: the bad file stays, nothing is rewritten
    before = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    assert daemon.scan_once(engine, str(src), str(out)) == 0
    assert {p.name: p.stat().st_mtime_ns for p in out.iterdir()} == before
