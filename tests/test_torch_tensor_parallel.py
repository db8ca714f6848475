"""Tensor parallelism in the port (`--model_parallel`), on the CPU with gloo.

The tiny f32 model and the global batch of `test_torch_distributed.py`
(vocab 20, so V+1 = 21 splits unevenly: 11 + 10 columns at M = 2, 6 + 5
+ 5 + 5 at M = 4; three frames and a repeat of the first at weight 0;
the sampler pinned by debug ordinals):

  * the layout: `param_shard_dims` names the leaves and dims of the JAX
    `param_pspecs`; shard then gather is the identity for the params and
    Adam's moments at V+1 = 10 001, M = 2 and 4;
  * two gloo ranks at M = 2, two steps with the finetune flip between,
    dropout off and at 0.5 (the ranks share one generator stream, so
    they draw the unsharded model's masks): the ranks' replicated
    parameters are bit-equal after every step, and each step equals one
    process's step on the whole batch from the same state (parameters,
    Adam state, generator state) within the bounds of
    `test_torch_distributed.py` (losses rtol 1e-4; parameters within 2 lr,
    1e-3 lr + 1e-6 where |g| is large); the first step's loss against the
    JAX package's `batched_loss` on a ('data', 'model') = (1, 2) mesh with
    its padded, sharded params, rtol 1e-5;
  * four ranks, data 2 x model 2 and data 1 x model 4, against one
    process on the global batch;
  * checkpoints: the pair written at M = 2 holds the full model (the
    projection V+1 wide, in the params and the moments) and loads in the
    JAX `load_params`; it resumes at M = 2 bit-equal to the uninterrupted
    run and at world 1 within the bounds; a world-1 pair resumes at M = 2;
  * the train CLI with `--num_processes 2 --model_parallel 2`, and the
    flags' rules.

Ranks run in subprocesses that meet at a `file://` store under tmp_path.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from densecap_tpu_torch.parallel import distributed, mesh
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.utils import checkpoint as ckpt
from test_torch_distributed import CFG, LR, _spawn, global_batch
from test_torch_train_cli import _args, dataset  # noqa: F401

META = json.dumps({"vocab_size": CFG.vocab_size})


def tp_snapshot(trainer, losses, gen_state):
    """One rank after a step: the full parameters (its shards gathered,
    the replicated ones as it holds them), the gathered Adam state, the
    losses and the generator's state before the step. Every rank of the
    model group must call it."""
    named = dict(trainer.model.named_parameters())
    return {"params": {n: (trainer.shards[n].gather(p.detach())
                           if n in trainer.shards else p.detach().clone())
                       for n, p in named.items()},
            "state": copy.deepcopy(trainer.state_dict()),
            "losses": {k: float(v) for k, v in losses.items()},
            "gen": gen_state}


def local_slice(batch):
    """This rank's slice of the global batch: its data index's."""
    n = batch["image"].shape[0] // distributed.data_size()
    d = distributed.data_rank()
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def run_steps(trainer, cfg_seed_gen, batch, dbg, steps, first=0,
              on_step=None):
    """Steps first..steps-1 (the flip before step 1) -> snapshots."""
    gen = torch.Generator().manual_seed(cfg_seed_gen)
    snaps = []
    for i in range(first, steps):
        if i == 1:
            trainer.set_finetune(True)
        state = gen.get_state()
        out = trainer.step(batch, generator=gen, debug_sampler=dbg)
        snaps.append(tp_snapshot(trainer, out, state))
        if on_step is not None:
            on_step(i)
    return snaps


def run_rank(rank, world, m, init, out, spec):
    """One rank (the subprocess's body) -> {"steps": two steps' snapshots
    from the seed-1 params, "resumed": {prefix: the second step resumed
    from that pair}}. spec (JSON): "drop" (the dropout probability),
    optionally "save" (a prefix: the pair is written after the first
    step) and "resume" (prefixes to resume from after the two steps)."""
    spec = json.loads(spec)
    torch.set_num_threads(1)
    assert distributed.initialize(init_method=init, num_processes=world,
                                  process_id=rank, device="cpu",
                                  model_parallel=m)
    try:
        assert (distributed.model_size(), distributed.model_rank(),
                distributed.data_size(), distributed.data_rank()) == (
                    m, rank % m, world // m, rank // m)
        cfg = CFG.replace(drop_prob=spec["drop"])
        batch, dbg = global_batch()
        local = local_slice(batch)
        model = ckpt.to_torch(ckpt.init_params(cfg, seed=1), cfg, "cpu",
                              train=True)
        trainer = Trainer(model, learning_rate=LR)
        assert trainer.distributed and len(trainer.shards) == 6

        def save(i):
            if i == 0 and spec.get("save"):
                ckpt.save_train_state(spec["save"], trainer, 1, META)

        result = {"steps": run_steps(trainer, 7, local, dbg, 2,
                                     on_step=save), "resumed": {}}
        for prefix in spec.get("resume", ()):
            model, state = ckpt.load_train_state(prefix, cfg, "cpu")
            trainer = Trainer(model, learning_rate=LR)
            trainer.load_state_dict(state)
            result["resumed"][prefix] = run_steps(trainer, 7, local, dbg, 2,
                                                  first=1)[0]
        torch.save(result, out)
    finally:
        distributed.shutdown()


def spawn(tmp_path, world, m, spec, tag):
    """Run `world` ranks at model_parallel m -> each rank's result."""
    code = ("import sys, test_torch_tensor_parallel as t\n"
            "t.run_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),"
            " sys.argv[4], sys.argv[5] + sys.argv[1], sys.argv[6])\n")
    _spawn(code, [str(world), str(m), f"file://{tmp_path}/{tag}",
                  str(tmp_path / f"{tag}_rank"), json.dumps(spec)],
           tmp_path, n=world)
    results = []
    for r in range(world):
        path = tmp_path / f"{tag}_rank{r}"
        results.append(torch.load(path, weights_only=True))
        path.unlink()  # the trunk's parameters and moments, 0.1-0.3 GB
    return results


def write_world1_pair(prefix):
    """The pair of a world-1 Trainer after its first step (dropout off)."""
    trainer = reference(CFG)
    reference_step(trainer, 0, torch.Generator().manual_seed(7).get_state())
    ckpt.save_train_state(prefix, trainer, 1, META)


def reference(cfg, snapshot=None):
    """A world-1 Trainer over the seed-1 parameters, or over those and
    the Adam state of a snapshot."""
    model = ckpt.to_torch(ckpt.init_params(cfg, seed=1), cfg, "cpu",
                          train=True)
    if snapshot is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snapshot["params"][n])
    trainer = Trainer(model, learning_rate=LR)
    if snapshot is not None:
        # a copy: Adam adopts tensors already on its device, and its
        # steps would write into the snapshot
        trainer.load_state_dict(copy.deepcopy(snapshot["state"]))
    return trainer


def reference_step(trainer, i, gen_state):
    """Step i on the whole batch from the generator state `gen_state` ->
    (snapshot, the step's gradients)."""
    batch, dbg = global_batch()
    if i == 1:
        trainer.set_finetune(True)
    gen = torch.Generator()
    gen.set_state(gen_state)
    out = trainer.step(batch, generator=gen, debug_sampler=dbg)
    named = dict(trainer.model.named_parameters())
    return (tp_snapshot(trainer, out, gen_state),
            {n: p.grad.clone() for n, p in named.items()
             if p.grad is not None})


def assert_within(got, want, grads, before, i, msg=""):
    """`test_torch_distributed.py`'s bounds on one step's losses and
    parameters; `before`: the parameters the step started from."""
    for k in want["losses"]:
        np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=msg + k)
    assert want["losses"]["stats/num_pos"] > 0
    for n, p0 in before.items():
        mine, ref = got["params"][n], want["params"][n]
        assert mine.shape == ref.shape == p0.shape, msg + n
        if n.startswith("trunk1.") or (n.startswith("trunk2.") and i == 0):
            assert torch.equal(mine, p0) and torch.equal(ref, p0), msg + n
            continue
        diff = (mine - ref).abs()
        assert float(diff.max()) <= 2 * LR + 1e-6, msg + n
        g = grads[n].abs()
        big = g > 1e-3 * g.max()
        assert float(diff[big].max()) <= 1e-3 * LR + 1e-6, msg + n
        assert not torch.equal(mine, p0), f"{msg}{n} did not move"


def check_against_one_process(ranks, cfg, m):
    """Peers bit-equal, and every step within the bounds of one process's
    step from the same state."""
    for snaps in ranks[1:]:
        for a, b in zip(ranks[0], snaps):
            assert a["losses"] == b["losses"]
            for n in a["params"]:
                assert torch.equal(a["params"][n], b["params"][n]), n
    before = reference(cfg)
    start = {n: p.detach().clone()
             for n, p in before.model.named_parameters()}
    for i, got in enumerate(ranks[0]):
        trainer = reference(cfg, ranks[0][i - 1] if i else None)
        want, grads = reference_step(trainer, i, got["gen"])
        prev = ranks[0][i - 1]["params"] if i else start
        assert_within(got, want, grads, prev, i, f"M={m} step {i}: ")
    # the sharded leaves were sharded: the projection's 21 columns split
    # as tensor_split splits them
    assert ranks[0][0]["params"]["lm.proj.w"].shape[-1] == CFG.vocab_size + 1


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """The M = 2 runs of two ranks, by dropout probability -> (each rank's
    result, the pair the run wrote, a world-1 pair). The run at 0 writes
    its pair after the first step and, after its two steps, resumes from
    that pair and from a world-1 one."""
    tmp = tmp_path_factory.mktemp("tp2")
    cache = {}

    def get(drop):
        if drop not in cache:
            spec = {"drop": drop}
            prefixes = (None, None)
            if drop == 0.0:
                prefixes = (str(tmp / "ck_tp" / "densecap"),
                            str(tmp / "ck_w1" / "densecap"))
                write_world1_pair(prefixes[1])
                spec.update(save=prefixes[0], resume=list(prefixes))
            cache[drop] = (spawn(tmp, 2, 2, spec, f"d{int(drop * 10)}"),
                           *prefixes)
        return cache[drop]

    return get


def test_shard_dims_match_jax_pspecs():
    import jax

    from densecap_tpu.models import densecap as jd
    from densecap_tpu.parallel import mesh as jmesh
    from test_torch_train_slice import JCFG

    # JAX's init_params tree, its leaves as zeros of their shapes
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jd.init_params(jax.random.PRNGKey(0), JCFG)))
    specs = jax.tree_util.tree_flatten_with_path(jmesh.param_pspecs(params))
    want = {}
    for path, spec in specs[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        dims = [d for d, a in enumerate(spec) if a == "model"]
        want[name] = dims[0] if dims else None
    got = mesh.param_shard_dims(params)
    assert got == want
    assert sorted(n for n, d in got.items() if d is not None) == [
        "lm/proj/b", "lm/proj/w", "recog/fc6/b", "recog/fc6/w",
        "recog/fc7/b", "recog/fc7/w"]


@pytest.mark.parametrize("m", [2, 4])
def test_shard_then_gather_is_the_identity(m):
    cfg = CFG.replace(vocab_size=10000)
    params = ckpt.init_params(cfg, seed=0)
    shards = [mesh.shard_params(params, r, m) for r in range(m)]
    widths = [s["lm"]["proj"]["w"].shape[1] for s in shards]
    assert widths == [len(c) for c in np.array_split(np.arange(10001), m)]
    assert [s["lm"]["proj"]["b"].shape[0] for s in shards] == widths
    assert all(s["recog"]["fc6"]["w"].shape == (7 * 7 * 512, 64 // m)
               for s in shards)
    back = mesh.gather_params(shards)
    flat, flat_back = dict(mesh._leaves(params)), dict(mesh._leaves(back))
    assert flat.keys() == flat_back.keys()
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=k)

    # Adam's moments, indexed by parameter position as torch keeps them
    model = ckpt.to_torch(params, cfg, "cpu", train=True)
    names = [n for n, _ in model.named_parameters()
             if not n.startswith("trunk1.")]
    shapes = dict((n, p.shape) for n, p in model.named_parameters())
    gen = torch.Generator().manual_seed(0)
    full = {"state": {i: {"step": torch.tensor(3.0),
                          "exp_avg": torch.randn(shapes[n], generator=gen),
                          "exp_avg_sq": torch.rand(shapes[n], generator=gen)}
                      for i, n in enumerate(names)},
            "param_groups": [{"params": list(range(len(names)))}]}
    parts = [mesh.shard_optimizer_state(full, names, r, m) for r in range(m)]
    i = names.index("lm.proj.w")
    assert [p["state"][i]["exp_avg"].shape[1] for p in parts] == widths
    back = mesh.gather_optimizer_state(parts, names)
    assert back["param_groups"] == full["param_groups"]
    for i, st in full["state"].items():
        for k, v in st.items():
            assert torch.equal(back["state"][i][k], v), (names[i], k)


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_two_ranks_match_one_process(two_rank_runs, drop):
    ranks = [r["steps"] for r in two_rank_runs(drop)[0]]
    assert all(len(r) == 2 for r in ranks)
    check_against_one_process(ranks, CFG.replace(drop_prob=drop), 2)


def test_two_ranks_loss_matches_jax_mesh(two_rank_runs):
    import functools

    import jax
    import jax.numpy as jnp

    from densecap_tpu.models import densecap as jd
    from densecap_tpu.parallel import mesh as jmesh
    from densecap_tpu.parallel import train_step as jts
    from test_torch_train_slice import JCFG

    ranks = [r["steps"] for r in two_rank_runs(0.0)[0]]
    batch, dbg = global_batch()
    jmesh_ = jmesh.make_mesh(2, model_parallel=2)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    ckpt.init_params(CFG, seed=1))
    sharded = jmesh.shard_params(params, jmesh_)
    assert sharded["lm"]["proj"]["w"].shape[1] == 22  # JAX pads 21 to 22
    pinned = functools.partial(
        jd.forward_train,
        debug_sampler={k: jnp.asarray(v.numpy()) for k, v in dbg.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts.densecap, "forward_train", pinned)
        ref = jax.jit(lambda p, b: jts.batched_loss(
            p, b, jax.random.PRNGKey(0), JCFG))(
                sharded, jmesh.shard_batch(
                    {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                    jmesh_))
    got = ranks[0][0]["losses"]
    for k in ("total_loss", "captioning_loss", "end_objectness_loss",
              "mid_objectness_loss", "end_box_reg_loss"):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("m", [2, 4], ids=["data2_model2", "data1_model4"])
def test_four_ranks_match_one_process(tmp_path, m):
    ranks = spawn(tmp_path, 4, m, {"drop": 0.0}, "w4")
    check_against_one_process([r["steps"] for r in ranks], CFG, m)


def test_checkpoints_resume_across_group_sizes(two_rank_runs):
    from densecap_tpu.utils import checkpoint as jckpt

    results, tp_prefix, w1_prefix = two_rank_runs(0.0)
    ranks = [r["steps"] for r in results]
    # the pair holds the full model: V+1 = 21 columns everywhere
    jparams, _ = jckpt.load_params(tp_prefix + ".npz")
    assert jparams["lm"]["proj"]["w"].shape == (CFG.rnn_size, 21)
    assert jparams["lm"]["proj"]["b"].shape == (21,)
    assert jparams["recog"]["fc6"]["w"].shape[1] == CFG.fc_dim
    model, state = ckpt.load_train_state(tp_prefix, CFG, "cpu")
    after_first = ranks[0][0]
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), after_first["params"][n]), n
    names = Trainer(model).names
    for i, st in state["optimizer"]["state"].items():
        want = after_first["state"]["optimizer"]["state"][i]
        for k in mesh.MOMENTS:
            assert st[k].shape == dict(model.named_parameters())[
                names[i]].shape, names[i]
            assert torch.equal(st[k], want[k]), (names[i], k)

    resumed = [r["resumed"] for r in results]
    assert list(resumed[0]) == [tp_prefix, w1_prefix]
    for a, b in zip(resumed[0].values(), resumed[1].values()):
        assert a["losses"] == b["losses"]
        assert all(torch.equal(a["params"][n], b["params"][n])
                   for n in a["params"])
    # at M = 2 from its own pair: the uninterrupted run's second step
    mine = resumed[0][tp_prefix]
    assert mine["losses"] == ranks[0][1]["losses"]
    for n, p in ranks[0][1]["params"].items():
        assert torch.equal(mine["params"][n], p), n
    # each pair at world 1 and at M = 2, the second step alike
    for prefix in (tp_prefix, w1_prefix):
        model, state = ckpt.load_train_state(prefix, CFG, "cpu")
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        trainer = Trainer(model, learning_rate=LR)
        trainer.load_state_dict(state)
        want, grads = reference_step(trainer, 1, resumed[0][prefix]["gen"])
        assert_within(resumed[0][prefix], want, grads, start, 1,
                      f"{os.path.basename(os.path.dirname(prefix))}: ")


def test_train_cli_model_parallel(dataset, tmp_path):  # noqa: F811
    """Two ranks, one model group (data axis 1, so both load the whole
    batch of 2), 2 iterations, evaluated and saved at 2."""
    from densecap_tpu.utils import checkpoint as jckpt

    code = ("import functools, sys, torch\n"
            "from densecap_tpu_torch.cli import train\n"
            "from densecap_tpu_torch.config import DenseCapConfig\n"
            "torch.set_num_threads(1)\n"
            "train.DenseCapConfig = functools.partial(DenseCapConfig, "
            "fc_dim=64)\n"
            "train.main(sys.argv[2:] + ['--process_id', sys.argv[1]])\n")
    prefix = str(tmp_path / "ck" / "densecap")
    outs = _spawn(code, _args(dataset, prefix, 2) + [
        "--num_processes", "2", "--model_parallel", "2",
        "--coordinator_address", f"file://{tmp_path}/store"], tmp_path)
    assert "model_parallel=2" in outs[0]
    assert "iter 2: val mAP" in outs[0] and "saved checkpoint" in outs[0]
    assert outs[1].strip() == "", outs[1]
    params, extra = jckpt.load_params(prefix + ".npz")
    meta = json.loads(str(extra["meta"]))
    v1 = meta["vocab_size"] + 1
    assert params["lm"]["proj"]["w"].shape[1] == v1
    assert params["recog"]["fc7"]["b"].shape == (64,)
    state = torch.load(prefix + ".optim.pt", weights_only=True)
    assert state["iter"] == 2 and state["count"] == 2
    widths = {st["exp_avg"].shape[-1] for st in
              state["optimizer"]["state"].values()}
    assert v1 in widths and 64 in widths


@pytest.mark.parametrize("flags,message", [
    (["--num_processes", "3", "--model_parallel", "2"],
     "--model_parallel 2 must divide --num_processes 3"),
    (["--model_parallel", "2"], "--model_parallel 2 needs --num_processes"),
    (["--num_processes", "4", "--model_parallel", "2", "--batch_size", "3"],
     "--batch_size 3 must be a multiple of the data axis 2"),
])
def test_train_cli_model_parallel_rules(dataset, tmp_path, flags,  # noqa: F811
                                        message):
    from densecap_tpu_torch.cli import train

    with pytest.raises(SystemExit, match=message):
        train.main(_args(dataset, str(tmp_path / "x"), 1) + flags)
    assert not distributed.is_initialized()


def test_groups_without_a_process_group():
    assert (distributed.model_size(), distributed.model_rank(),
            distributed.data_size(), distributed.data_rank()) == (1, 0, 1, 0)
    assert distributed.model_group() is None
    assert distributed.data_group() is None
    assert mesh.split_columns(21, 2) == [(0, 11), (11, 21)]
    assert mesh.split_columns(10001, 4) == [(0, 2501), (2501, 5001),
                                            (5001, 7501), (7501, 10001)]
