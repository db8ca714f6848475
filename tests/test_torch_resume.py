"""Resuming training in the port.

  * `Trainer` state through `save_train_state` / `load_train_state`: the
    next step is bit-equal to the uninterrupted one on the CPU (same batch,
    a fresh generator of the same seed on both sides), before and after
    the finetune flip;
  * the train CLI: 4 iterations, checkpointed at 2, resumed to 4 with
    `--checkpoint_start_from`;
  * a JAX TrainState (two steps, the second after the flip), saved by the
    JAX package's orbax `save_train_state` and converted by
    `scripts/torch_import_jax_state.py`: parameters and Adam moments
    equal exactly, and one more step on both sides within the bounds of
    `test_torch_train_slice.py` (2 lr everywhere, 1e-3 lr + 1e-6 where
    |g| is large; for trunk2, at its second Adam step, "large" starts
    higher, as the test says why).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from densecap_tpu.parallel import train_step as jts
from densecap_tpu.utils import checkpoint as jckpt
from densecap_tpu_torch.cli import train as train_cli
from densecap_tpu_torch.parallel.train_step import (Trainer,
                                                    cosine_decay_schedule)
from densecap_tpu_torch.utils import checkpoint as ckpt
from test_torch_train_cli import _args, dataset, narrow_fc  # noqa: F401
from test_torch_train_slice import (JCFG, LR, PCFG, _flat, _port_dbg,
                                    _torch_batch, setup)  # noqa: F401
from test_torch_train_weight import _bucket_batch, jax_batched_loss

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECAY = 10  # cosine decay steps, so the schedule's count matters


def _tree_of(model, tensors):
    """`tensors` (name -> tensor, the model's parameter names) in the JAX
    tree layout, through `from_torch`."""
    saved = {n: p.data for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.data = tensors.get(n, torch.zeros_like(p))
    try:
        return _flat(ckpt.from_torch(model))
    finally:
        for n, p in model.named_parameters():
            p.data = saved[n]


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("flip", [False, True], ids=["frozen", "finetune"])
def test_trainer_round_trip_next_step_bit_equal(tmp_path, flip):
    batch = _torch_batch(_bucket_batch())
    params = ckpt.init_params(PCFG, seed=1)
    model = ckpt.to_torch(params, PCFG, "cpu", train=True)
    lr = cosine_decay_schedule(LR, DECAY, alpha=0.02)
    trainer = Trainer(model, learning_rate=lr)
    trainer.step(batch, generator=torch.Generator().manual_seed(1))
    if flip:
        trainer.set_finetune(True)
        trainer.step(batch, generator=torch.Generator().manual_seed(2))
    prefix = str(tmp_path / "ck" / "run")
    ckpt.save_train_state(prefix, trainer, 1 + flip, json.dumps({}))

    model2, state = ckpt.load_train_state(prefix, PCFG, "cpu")
    assert state["iter"] == 1 + flip and state["count"] == 1 + flip
    resumed = Trainer(model2, learning_rate=lr)
    resumed.load_state_dict(state)
    assert resumed.finetune_cnn == flip
    assert model2.cfg.static_freeze_cnn == (not flip)
    # trunk2 has Adam state only after the flip, on both sides
    assert all((p in resumed.opt.state) == flip for p in resumed.cnn)
    for t in (trainer, resumed):
        t.step(batch, generator=torch.Generator().manual_seed(3))
    assert resumed.count == trainer.count == 2 + flip
    before, after = _params(model), _params(model2)
    assert all(torch.equal(before[n], after[n]) for n in before)
    for p, q in zip(trainer.main + trainer.cnn, resumed.main + resumed.cnn):
        a, b = trainer.opt.state.get(p, {}), resumed.opt.state.get(q, {})
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_resume_keeps_its_own_betas_and_eps(tmp_path):
    """The saved param_groups carry the first run's betas and eps; the
    resumed Trainer steps with those it was built with, as the JAX CLI
    builds its optimizer from its flags at resume."""
    batch = _torch_batch(_bucket_batch())
    model = ckpt.to_torch(ckpt.init_params(PCFG, seed=1), PCFG, "cpu",
                          train=True)
    trainer = Trainer(model, learning_rate=LR)
    trainer.step(batch, generator=torch.Generator().manual_seed(1))
    prefix = str(tmp_path / "run")
    ckpt.save_train_state(prefix, trainer, 1, json.dumps({}))

    model2, state = ckpt.load_train_state(prefix, PCFG, "cpu")
    resumed = Trainer(model2, learning_rate=LR, beta1=0.5, beta2=0.9,
                      eps=1e-6)
    resumed.load_state_dict(state)
    assert all(g["betas"] == (0.5, 0.9) and g["eps"] == 1e-6
               for g in resumed.opt.param_groups)
    before = _params(model2)
    moments = {p: {k: v.clone() for k, v in resumed.opt.state[p].items()}
               for p in resumed.main}
    resumed.step(batch, generator=torch.Generator().manual_seed(2))
    # torch's Adam with the new hyperparameters, on the same moments and
    # the gradient the step used (weight decay included)
    for n, p in model2.named_parameters():
        if p not in moments:
            continue
        q = before[n].clone().requires_grad_()
        ref = torch.optim.Adam([q], lr=LR, betas=(0.5, 0.9), eps=1e-6)
        ref.state[q] = moments[p]
        q.grad = p.grad.clone()
        ref.step()
        assert torch.equal(q.detach(), p.detach()), n


def test_train_cli_resumes(dataset, tmp_path, narrow_fc, capsys):  # noqa: F811
    """Run A: 2 iterations, the flip at 1, evaluated and saved at 2. Run
    B resumes A's pair and runs to 4."""
    common = ["--save_checkpoint_every", "2", "--cosine_decay_steps",
              str(DECAY), "--finetune_cnn_after", "1"]
    a = str(tmp_path / "a" / "densecap")
    train_cli.main(_args(dataset, a, 2) + common)
    saved = torch.load(a + ".optim.pt", weights_only=True)
    assert saved["iter"] == 2 and saved["count"] == 2
    assert saved["finetune_cnn"]
    capsys.readouterr()

    b = str(tmp_path / "b" / "densecap")
    train_cli.main(_args(dataset, b, 4) + common
                   + ["--checkpoint_start_from", a])
    out = capsys.readouterr().out
    assert f"resumed from {a} at iteration 2" in out
    assert "enabling CNN finetuning" not in out  # the flip holds
    with open(b + ".json") as f:
        hist = json.load(f)
    assert hist["iter"] == 4
    assert sorted(map(int, hist["loss_history"])) == [3, 4]
    assert sorted(map(int, hist["results_history"])) == [4]
    state = torch.load(b + ".optim.pt", weights_only=True)
    assert state["iter"] == 4 and state["count"] == 4
    assert state["finetune_cnn"]
    steps = sorted({int(s["step"])
                    for s in state["optimizer"]["state"].values()})
    assert steps == [3, 4]  # trunk2 since the flip, the rest since 0


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_import_jax_state",
        os.path.join(ROOT, "scripts", "torch_import_jax_state.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_train_state_import(setup, tmp_path):
    sched = optax.cosine_decay_schedule(LR, DECAY, alpha=0.02)
    state, _ = jts.init_state(jax.random.PRNGKey(0), JCFG,
                              learning_rate=sched, params=setup["params"])
    jbatch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    frozen = JCFG.replace(static_freeze_cnn=True)
    state, _ = jts.train_step(state, jbatch, jax.random.PRNGKey(1), frozen,
                              jts.make_optimizer(frozen, learning_rate=sched))
    state = state._replace(finetune_cnn=jnp.ones((), bool))
    tx = jts.make_optimizer(JCFG, learning_rate=sched)
    state, _ = jts.train_step(state, jbatch, jax.random.PRNGKey(2), JCFG, tx)
    state_dir = jckpt.save_train_state(str(tmp_path / "jax"), state)
    jckpt.save_params(str(tmp_path / "jax.npz"), state.params, extra={
        "meta": json.dumps({"config": JCFG.to_json()})})
    out = str(tmp_path / "port")
    _script().main(["--state_dir", state_dir, "--npz",
                    str(tmp_path / "jax.npz"), "--output", out,
                    "--cosine_decay_steps", str(DECAY)])

    model, saved = ckpt.load_train_state(out, PCFG, "cpu")
    trainer = Trainer(model, learning_rate=cosine_decay_schedule(
        LR, DECAY, alpha=0.02))
    trainer.load_state_dict(saved)
    assert saved["iter"] == 2 and trainer.count == 2 and trainer.finetune_cnn
    ref = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    got = _flat(ckpt.from_torch(model))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the moments, exactly, zone by zone, with each zone's count
    zones = state.opt_state[0].inner_states
    names = dict(model.named_parameters())
    for zone, params, count in (("main", trainer.main, 2),
                                ("cnn", trainer.cnn, 1)):
        adam = zones[zone].inner_state
        assert int(adam.count) == count
        st = [trainer.opt.state[p] for p in params]
        assert all(int(s["step"]) == count for s in st)
        ids = {id(p) for p in params}
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            mine = _tree_of(model, {n: trainer.opt.state[p][key]
                                    for n, p in names.items()
                                    if id(p) in ids})
            for k, v in _flat({g: t for g, t in tree.items()
                               if isinstance(t, dict)}).items():
                np.testing.assert_array_equal(mine[k], v, err_msg=k)

    # one more step on both sides, the sampler pinned
    _, grads = jax_batched_loss(state.params, setup["batch"], setup["dbg"],
                                JCFG, grad=True)
    zone_of = jts.param_zones(state.params)
    grads = {k: (jax.tree_util.tree_map(
        lambda gi, pi: gi + JCFG.weight_decay * pi, g, state.params[k])
        if zone_of[k] != "frozen" else jax.tree_util.tree_map(jnp.zeros_like,
                                                              g))
        for k, g in grads.items()}
    updates, _ = tx.update(grads, state.opt_state, state.params)
    ref = _flat(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(state.params, updates)))
    g = _flat(grads)
    # from_torch shares the memory of 2-d and 1-d parameters: copy
    before = {k: v.copy() for k, v in _flat(ckpt.from_torch(model)).items()}
    trainer.step(_torch_batch(setup["batch"]),
                 debug_sampler=_port_dbg(setup["dbg"]))
    got = _flat(ckpt.from_torch(model))
    for k in ref:
        if k.startswith("trunk1/"):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            continue
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2 * LR + 1e-6, k
        # Past Adam's first step the update amplifies a gradient error by
        # (1 - b1) / (1 - b1^t) / sqrt(v): trunk2's gradients (five convs
        # deeper) agree to ~1e-4 of their scale, and this is its second
        # step, so its |g| counts as large from 3e-2 of the leaf's
        # largest; the main zone's (third step) from 1e-3, as in the slice
        large = 3e-2 if k.startswith("trunk2/") else 1e-3
        big = np.abs(g[k]) > large * np.abs(g[k]).max()
        assert diff[big].max(initial=0.0) <= 1e-3 * LR + 1e-6, k
        assert np.abs(got[k] - before[k]).max() > 0, f"{k} did not move"
