"""Data-parallel inference of the port (`parallel/mesh.py`) against the
JAX package's mesh.

  * `eval_split` over replicas on [cpu, cpu] (and three) against the JAX
    `eval_split` on a `make_mesh(n_devices=2)` of the 8-device CPU mesh,
    at batch 2 and 4 over a 5-image split (a tail that does not divide):
    map and detmap within 1e-6;
  * the micro-batching engine over two CPU replicas against the JAX mesh
    engine: boxes within rtol 1e-4 / atol 1e-3, captions equal; the
    engine's check that the batch divides over the devices;
  * `evaluate_model --data_parallel` against the JAX CLI: the same
    result, and the same message for a batch that does not divide;
  * `data_devices`: never fewer devices than asked for, and both CLIs
    refuse `--data_parallel` past the visible GPUs;
  * `Replicas`: shards in batch order, each replica's own thread, a
    copy per further device (int8 buffers too).
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from densecap_tpu.cli import evaluate_model as jax_evaluate
from densecap_tpu.eval.eval_split import eval_split as jax_eval_split
from densecap_tpu.models import densecap as jd
from densecap_tpu.parallel import mesh as jax_mesh
from densecap_tpu.serve.engine import InferenceEngine as JaxEngine
from densecap_tpu.utils import checkpoint as jax_ckpt
from densecap_tpu_torch.cli import evaluate_model
from densecap_tpu_torch.data.loader import DenseCapLoader
from densecap_tpu_torch.eval.eval_split import eval_split
from densecap_tpu_torch.ops.quant import quantize_for_inference
from densecap_tpu_torch.parallel import mesh
from densecap_tpu_torch.serve import server
from densecap_tpu_torch.serve.engine import InferenceEngine
from densecap_tpu_torch.utils.checkpoint import to_torch
from densecap_tpu_torch.utils.image import to_model_input
from test_torch_eval import _loaders, make_dataset, tiny_configs
from test_torch_serving import IDX_TO_TOKEN, JCFG, PCFG

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = make_dataset(tmp_path_factory.mktemp("torch_dp"))
    loader = DenseCapLoader(root / "d.h5", root / "d.json", max_gt_boxes=4)
    jcfg, pcfg = tiny_configs(loader.vocab_size(), loader.seq_length(),
                              loader.canvas)
    meta = json.dumps({"vocab_size": jcfg.vocab_size,
                       "seq_length": jcfg.seq_length,
                       "idx_to_token": loader.info["idx_to_token"],
                       "config": jcfg.to_json()})
    loader.close()
    params = jd.init_params(jax.random.PRNGKey(3), jcfg)
    jax_ckpt.save_params(str(root / "ck.npz"), params, extra={"meta": meta})
    model = to_torch(jax.tree_util.tree_map(np.asarray, params), pcfg, CPU)
    return root, params, jcfg, model


@pytest.mark.parametrize("batch_size,n_dev", [(2, 2), (4, 2), (4, 3)])
def test_eval_split_over_replicas_matches_jax_mesh(setup, batch_size, n_dev):
    root, params, jcfg, model = setup
    jloader, ploader = _loaders(root)
    jm = jax_mesh.make_mesh(n_devices=2, model_parallel=1)
    jb = 4 if batch_size == 4 else 2  # the JAX mesh needs a multiple of 2
    ref = jax_eval_split(params, jloader, jcfg, split=1, verbose=False,
                         compute_losses=False, batch_size=jb, mesh=jm)
    got = eval_split(model, ploader, split=1, verbose=False,
                     compute_losses=False, batch_size=batch_size,
                     devices=[CPU] * n_dev)
    ploader.close()
    assert ploader.split_size(1) % batch_size  # the tail does not divide
    for key in ("map", "detmap"):
        assert got["ap_results"][key] == pytest.approx(
            ref["ap_results"][key], rel=0, abs=1e-6)
    assert got["ap_results"]["detmap"] > 0


def test_eval_split_runs_each_shard_on_its_replica_thread(setup,
                                                          monkeypatch):
    root, _, _, model = setup
    seen = []
    real = type(model).forward_test_batch

    def fwd(self, images, *a, **kw):
        seen.append((threading.current_thread().name, images.shape[0]))
        return real(self, images, *a, **kw)

    monkeypatch.setattr(type(model), "forward_test_batch", fwd)
    ploader = _loaders(root)[1]
    eval_split(model, ploader, split=1, verbose=False, batch_size=4,
               devices=[CPU, CPU])
    ploader.close()
    # 5 images: shards of 2 and 2, then the tail of 1 on the first replica
    assert sorted(n for _, n in seen) == [1, 2, 2]
    assert [name for name, n in seen if n == 1][0].startswith("replica0")
    names = {name for name, _ in seen}
    assert len(names) == 2 and all(n.startswith("replica") for n in names)
    assert not any(t.name.startswith("replica")
                   for t in threading.enumerate())  # closed after the split


@pytest.fixture(scope="module")
def engine_params():
    p = jd.init_params(jax.random.PRNGKey(0), JCFG)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _frames(n):
    rng = np.random.default_rng(5)
    shapes = [(100, 80), (64, 64), (50, 90), (70, 70), (90, 60)]
    return [rng.integers(0, 256, (*shapes[i % 5], 3), dtype=np.uint8)
            for i in range(n)]


def _concurrent(engine, frames):
    with ThreadPoolExecutor(len(frames)) as ex:
        return list(ex.map(lambda i: engine.process_array(
            frames[i], stream_id=str(i)), range(len(frames))))


def test_engine_over_replicas_matches_jax_mesh_engine(engine_params):
    frames = _frames(6)
    jm = jax_mesh.make_mesh(n_devices=2, model_parallel=1)
    ref = _concurrent(JaxEngine(engine_params[0], JCFG, IDX_TO_TOKEN,
                                max_boxes=5, smoothing=False, batch_size=4,
                                batch_window_ms=50.0, mesh=jm), frames)
    eng = InferenceEngine(engine_params[1], PCFG, IDX_TO_TOKEN, device=CPU,
                          max_boxes=5, smoothing=False, batch_size=4,
                          batch_window_ms=50.0, devices=[CPU, CPU])
    try:
        assert eng.replicas is not None and len(eng.replicas) == 2
        got = _concurrent(eng, frames)
    finally:
        eng.close()
    assert not any(t.name.startswith("replica")
                   for t in threading.enumerate())
    for g, r in zip(got, ref):
        assert 0 < len(g["boxes"]) <= 5
        assert g["captions"] == r["captions"]
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=1e-4,
                                   atol=1e-3)


def test_engine_replica_error_reaches_every_request(engine_params):
    eng = InferenceEngine(engine_params[1], PCFG, IDX_TO_TOKEN, device=CPU,
                          smoothing=False, batch_size=2,
                          request_timeout_s=30, devices=[CPU, CPU])

    def broken(*a, **k):
        raise ValueError("boom")

    eng.model.forward_test_batch = broken
    try:
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(eng.process_array, f) for f in _frames(2)]
            for f in futs:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=60)
    finally:
        eng.close()
    assert not any(t.is_alive() for t in eng._threads)


@pytest.mark.parametrize("batch_size", [3, 5])
def test_engine_batch_must_divide_over_devices_as_in_jax(engine_params,
                                                        batch_size):
    jm = jax_mesh.make_mesh(n_devices=2, model_parallel=1)
    with pytest.raises(ValueError, match="multiple"):
        JaxEngine(engine_params[0], JCFG, IDX_TO_TOKEN, batch_size=batch_size,
                  mesh=jm)
    with pytest.raises(ValueError, match="multiple"):
        InferenceEngine(engine_params[1], PCFG, IDX_TO_TOKEN, device=CPU,
                        batch_size=batch_size, devices=[CPU, CPU])


def _cli_args(root):
    return ["--checkpoint", str(root / "ck.npz"), "--data_h5",
            str(root / "d.h5"), "--data_json", str(root / "d.json"),
            "--split", "val", "--max_gt_boxes", "4", "--num_proposals", "10",
            "--skip_losses", "1"]


def test_evaluate_model_data_parallel_matches_jax(setup, capsys,
                                                  monkeypatch):
    monkeypatch.setenv("DENSECAP_NO_COMPILATION_CACHE", "1")
    args = _cli_args(setup[0]) + ["--data_parallel", "2", "--batch_size",
                                  "2"]
    jax_evaluate.main(args)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate_model.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("map", "detmap"):
        assert got[key] == pytest.approx(ref[key], rel=0, abs=1e-6)


@pytest.mark.parametrize("dp,bs", [(3, 4), (2, 1)])
def test_evaluate_model_batch_check_matches_jax(setup, dp, bs, monkeypatch):
    monkeypatch.setenv("DENSECAP_NO_COMPILATION_CACHE", "1")
    args = _cli_args(setup[0]) + ["--data_parallel", str(dp),
                                  "--batch_size", str(bs)]
    with pytest.raises(SystemExit) as ref:
        jax_evaluate.main(args)
    with pytest.raises(SystemExit) as got:
        evaluate_model.main(args + ["--device", "cpu"])
    assert str(got.value) == str(ref.value) == (
        f"--batch_size {bs} must be a multiple of --data_parallel {dp}")


def test_data_devices_never_shrinks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.data_devices(2, "cuda") == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    assert mesh.data_devices(1, "cuda:1") == [torch.device("cuda", 1)]
    for n, dev in ((3, "cuda"), (2, "cuda:1")):
        with pytest.raises(ValueError, match="CUDA devices"):
            mesh.data_devices(n, dev)
    assert mesh.data_devices(3, "cpu") == [CPU] * 3
    with pytest.raises(ValueError):
        mesh.data_devices(0, "cpu")


@pytest.mark.parametrize("cli", ["evaluate_model", "server"])
def test_clis_refuse_more_gpus_than_exist(setup, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    flags = ["--data_parallel", "2", "--batch_size", "2", "--device", "cuda"]
    with pytest.raises(SystemExit, match="needs 2 CUDA devices, but 1"):
        if cli == "server":
            server.main(["--checkpoint", str(setup[0] / "ck.npz"), *flags])
        else:
            evaluate_model.main(_cli_args(setup[0]) + flags)


def test_replicas_run_shards_in_order(setup):
    _, _, _, model = setup
    rng = np.random.default_rng(2)
    S = model.cfg.image_size
    canvases = rng.integers(0, 256, (5, S, S, 3), dtype=np.uint8)
    hs, ws = [64.0, 48.0, 64.0, 30.0, 64.0], [48.0, 64.0, 64.0, 64.0, 20.0]
    sizes = []

    def total(m, x, h, w):
        sizes.append(len(x))
        return x.sum((1, 2, 3))

    reps = mesh.Replicas(model, [CPU] * 3)
    try:
        outs = reps.run(canvases, hs, ws, fn=total)
    finally:
        reps.close()
    assert sorted(sizes) == [1, 2, 2]
    whole = to_model_input(canvases, hs, ws, CPU)[0].sum((1, 2, 3))
    torch.testing.assert_close(torch.cat(outs), whole, rtol=0, atol=0)
    assert [len(o) for o in outs] == [2, 2, 1]


def test_replicate_copies_parameters_and_int8_buffers(engine_params):
    model = to_torch(quantize_for_inference(engine_params[1]), PCFG, CPU)
    copy = mesh.replicate(model, CPU)
    a = dict(model.named_parameters()) | dict(model.named_buffers())
    b = dict(copy.named_parameters()) | dict(copy.named_buffers())
    assert a.keys() == b.keys() and any(v.dtype == torch.int8
                                        for v in b.values())
    for k in a:
        assert torch.equal(a[k], b[k])
    x, h, w = to_model_input([f[:64, :64] for f in _frames(2)],
                             [64.0, 50.0], [64.0, 64.0], CPU)
    ref, got = (m.forward_test_batch(x, h, w) for m in (model, copy))
    for k in ("boxes", "scores", "captions", "valid"):
        assert torch.equal(getattr(ref, k), getattr(got, k))
    reps = mesh.Replicas(model, [CPU, CPU])
    reps.close()
    assert reps.models[0] is reps.models[1] is model
