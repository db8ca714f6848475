"""Multi-process data parallel training in the port, on the CPU with gloo.

  * Two ranks in subprocesses, a global batch of 4 (three images and a
    repeat of the first at weight 0, two per rank), two steps with the
    finetune flip between them: the ranks' parameters are bit-equal, and
    each step equals one process's step on the whole batch from the same
    state within the bounds of `test_torch_train_slice.py` (losses rtol
    1e-4; parameters within 2 lr, and 1e-3 lr + 1e-6 where |g| is large).
    Step by step, because Adam's first update is about lr * sign(g): where
    |g| is at the level of the rounding difference, the two runs' first
    steps may differ by up to 2 lr, and two runs left to diverge carry
    that into every later gradient. f32, dropout off, the sampler pinned
    by debug ordinals, so both runs draw the same sample.
  * The train CLI with `--num_processes 2` on a tiny h5: both ranks exit
    0 and only rank 0 prints, evaluates and writes.

The ranks meet through a `file://` store under the test's tmp_path (no
fixed port), and each subprocess has its own timeout.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.parallel import distributed
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.utils.checkpoint import init_params, to_torch
from test_torch_train_cli import _args, dataset  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CFG = DenseCapConfig(
    vocab_size=20, seq_length=4, image_size=96,
    anchors=((8, 8), (16, 16), (12, 24), (24, 12)), rnn_size=32,
    rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
    sampler_batch_size=16, max_gt_boxes=6, drop_prob=0.0, weight_decay=1e-3,
    compute_dtype=torch.float32)
LR = 1e-3
TIMEOUT = 300


def global_batch():
    """Three 96 px canvases of different extents and a repeat of the
    first at weight 0, with the sampler's debug ordinals."""
    rng = np.random.default_rng(0)
    hs, ws = np.float32([96, 72, 80]), np.float32([80, 96, 64])
    ims = (rng.standard_normal((3, 96, 96, 3)) * 30).astype(np.float32)
    for i in range(3):
        ims[i, int(hs[i]):] = 0
        ims[i, :, int(ws[i]):] = 0
    wh = rng.uniform(12, 36, (3, 6, 2))
    xy = rng.uniform(wh / 2 + 1, np.stack([ws, hs], -1)[:, None] - wh / 2)
    labels = rng.integers(1, 21, (3, 6, 4))
    labels[:, :, 3] = 0
    batch = {"image": ims, "height": hs, "width": ws,
             "gt_boxes": np.concatenate([xy, wh], -1).astype(np.float32),
             "gt_labels": labels,
             "gt_valid": np.arange(6)[None] < np.array([[4], [3], [5]])}
    batch = {k: torch.from_numpy(np.concatenate([v, v[:1]]))
             for k, v in batch.items()}
    batch["weight"] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    dbg = {"pos": torch.from_numpy(rng.permutation(8)),
           "neg": torch.from_numpy(rng.permutation(16))}
    return batch, dbg


def make_trainer(snapshot=None):
    """A Trainer over the seed-1 parameters, or over those of a
    `train_step` snapshot with its optimizer state (distributed when the
    process group is up)."""
    model = to_torch(init_params(CFG, seed=1), CFG, "cpu", train=True)
    if snapshot is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snapshot["params"][n])
    trainer = Trainer(model, learning_rate=LR)
    if snapshot is not None:
        trainer.load_state_dict(snapshot["state"])
    return trainer


def train_step(trainer, batch, dbg, i):
    """Step i (0 or 1; the finetune flip before step 1) -> a snapshot:
    parameters, optimizer state, losses and the step's gradients."""
    if i == 1:
        trainer.set_finetune(True)
    out = trainer.step(batch, debug_sampler=dbg)
    named = dict(trainer.model.named_parameters())
    return {"params": {n: p.detach().clone() for n, p in named.items()},
            "state": copy.deepcopy(trainer.state_dict()),
            "losses": {k: float(v) for k, v in out.items()},
            "grads": {n: p.grad.clone() for n, p in named.items()
                      if p.grad is not None}}


def run_rank(rank, init_method, out):
    """One rank of the two-process run (the subprocess's body): its
    snapshots after each step."""
    torch.set_num_threads(1)
    assert distributed.initialize(init_method=init_method, num_processes=2,
                                  process_id=rank, device="cpu")
    try:
        assert (distributed.rank(), distributed.world_size()) == (rank, 2)
        assert distributed.is_main_process() == (rank == 0)
        batch, dbg = global_batch()
        local = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
        trainer = make_trainer()
        assert trainer.distributed
        torch.save([train_step(trainer, local, dbg, i) for i in range(2)],
                   out)
    finally:
        distributed.shutdown()


def _spawn(code, args, tmp_path, n=2):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, TESTS]))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), *args],
                              cwd=str(tmp_path), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [o for o, _ in outs]


def test_two_gloo_ranks_match_one_process(tmp_path):
    code = ("import sys, test_torch_distributed as t\n"
            "t.run_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3] + "
            "sys.argv[1])\n")
    _spawn(code, [f"file://{tmp_path}/store", str(tmp_path / "rank")],
           tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}", weights_only=True)
             for r in (0, 1)]
    for a, b in zip(*ranks):
        assert a["losses"] == b["losses"]
        for n, p in a["params"].items():
            assert torch.equal(p, b["params"][n]), n

    # each step against one process's on the whole batch, from the same
    # state: the parameters, Adam state and flag the ranks held before it
    torch.set_num_threads(2)
    batch, dbg = global_batch()
    start = make_trainer()
    for i, got in enumerate(ranks[0]):
        before = ranks[0][i - 1] if i else None
        ref = train_step(make_trainer(before), batch, dbg, i)
        for k in ref["losses"]:
            np.testing.assert_allclose(got["losses"][k], ref["losses"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert ref["losses"]["stats/num_pos"] > 0
        for n, p0 in start.model.named_parameters():
            mine, want = got["params"][n], ref["params"][n]
            if n.startswith("trunk1.") or (n.startswith("trunk2.")
                                           and i == 0):
                assert torch.equal(mine, p0.detach()), n
                assert torch.equal(want, mine), n
                continue
            diff = (mine - want).abs()
            assert float(diff.max()) <= 2 * LR + 1e-6, n
            g = ref["grads"][n].abs()
            big = g > 1e-3 * g.max()
            assert float(diff[big].max()) <= 1e-3 * LR + 1e-6, n
            assert not torch.equal(mine, p0.detach()), f"{n} did not move"


def test_train_cli_two_processes(dataset, tmp_path):  # noqa: F811
    """Global batch 2 over 2 ranks (one image each from a round-robin
    shard of the three train images), 2 iterations, evaluated at 2."""
    code = ("import functools, sys, torch\n"
            "from densecap_tpu_torch.cli import train\n"
            "from densecap_tpu_torch.config import DenseCapConfig\n"
            "torch.set_num_threads(1)\n"
            "train.DenseCapConfig = functools.partial(DenseCapConfig, "
            "fc_dim=64)\n"
            "train.main(sys.argv[2:] + ['--process_id', sys.argv[1]])\n")
    prefix = str(tmp_path / "ck" / "densecap")
    outs = _spawn(code, _args(dataset, prefix, 2) + [
        "--num_processes", "2", "--coordinator_address",
        f"file://{tmp_path}/store"], tmp_path)
    assert "iter 2: val mAP" in outs[0] and "saved checkpoint" in outs[0]
    assert outs[1].strip() == "", outs[1]
    with open(prefix + ".json") as f:
        hist = json.load(f)
    assert hist["iter"] == 2 and hist["opt"]["num_processes"] == 2
    assert sorted(map(int, hist["loss_history"])) == [1, 2]
    state = torch.load(prefix + ".optim.pt", weights_only=True)
    assert state["iter"] == 2 and state["count"] == 2


def test_rank_device_and_single_process(monkeypatch):
    assert distributed.initialize(num_processes=None) is False
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.is_main_process()
    distributed.barrier()  # no group: returns at once
    # a rank's device, rank, world, store and G come from its launcher
    # alone
    for k in (distributed.DEVICE_ENV, distributed.RANK_ENV,
              distributed.WORLD_ENV, distributed.STORE_ENV,
              distributed.LOCAL_ENV):
        monkeypatch.delenv(k, raising=False)
    assert distributed.launched() is None
    monkeypatch.setenv(distributed.DEVICE_ENV, "cuda:1")
    monkeypatch.setenv(distributed.RANK_ENV, "3")
    monkeypatch.setenv(distributed.WORLD_ENV, "4")
    monkeypatch.setenv(distributed.STORE_ENV, "tcp://127.0.0.1:29500")
    monkeypatch.setenv(distributed.LOCAL_ENV, "2")
    assert distributed.launched() == (torch.device("cuda", 1), 3, 4,
                                      "tcp://127.0.0.1:29500", 2)


def test_batch_must_divide_across_processes(dataset, tmp_path):  # noqa: F811
    from densecap_tpu_torch.cli import train

    # a multi-host call names its coordinator (as the JAX CLI must, with
    # no cluster to take it from)
    with pytest.raises(SystemExit, match="divide evenly across 2 processes"):
        train.main(_args(dataset, str(tmp_path / "x"), 1)
                   + ["--batch_size", "3", "--num_processes", "2",
                      "--coordinator_address", f"file://{tmp_path}/store"])
