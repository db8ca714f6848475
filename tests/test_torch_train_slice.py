"""The training slice end to end: the port's `forward_train`, its
gradients and one optimizer step against the JAX package on the same
(bridged) weights and inputs.

Two images with different extents on the 96 px canvas, f32, dropout off,
and the sampler pinned by debug ordinals (the two packages' random
streams differ). Losses agree to rtol 1e-4; each trainable leaf's
gradient to 1e-3 of that leaf's largest entry (conv and matmul
accumulation orders differ between XLA:CPU and torch). The JAX step is
built from `forward_train(debug_sampler=...)`, `param_zones` and
`make_optimizer`: `train_step` itself draws its sampler key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.parallel import train_step as jts
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.parallel.train_step import (Trainer, batched_loss,
                                                    cosine_decay_schedule)
from densecap_tpu_torch.utils.checkpoint import from_torch, to_torch

torch.set_num_threads(2)
TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)), rnn_size=32,
            rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
            sampler_batch_size=16, max_gt_boxes=6, drop_prob=0.0,
            weight_decay=1e-3)
JCFG = JaxConfig(**TINY, compute_dtype=jnp.float32)
PCFG = DenseCapConfig(**TINY, compute_dtype=torch.float32)
HS, WS = np.float32([96, 72]), np.float32([80, 96])
P, M = 8, 16
LR = 1e-3
LOSS_KEYS = ("mid_objectness_loss", "mid_box_reg_loss", "box_decay_loss",
             "end_objectness_loss", "end_box_reg_loss", "captioning_loss",
             "total_loss", "stats/num_pos", "stats/sampler_no_negatives",
             "stats/sampler_neg_replaced")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    params = jd.init_params(jax.random.PRNGKey(0), JCFG)
    # a non-zero box head, so the box branches carry gradient
    for i, (a, b) in enumerate([("rpn", "box"), ("box_reg", None)]):
        leaf = params[a] if b is None else params[a][b]
        leaf["w"] = 0.01 * jax.random.normal(
            jax.random.PRNGKey(i + 1), leaf["w"].shape, jnp.float32)
    rng = np.random.default_rng(0)
    ims = (rng.standard_normal((2, 96, 96, 3)) * 30).astype(np.float32)
    for i in range(2):  # normalized canvases are zero past the extent
        ims[i, int(HS[i]):] = 0
        ims[i, :, int(WS[i]):] = 0
    xy = rng.uniform(20, 70, (2, 6, 2))
    wh = rng.uniform(12, 40, (2, 6, 2))
    gt_boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    gt_labels = rng.integers(1, 21, (2, 6, 4)).astype(np.int32)
    gt_labels[:, :, 3] = 0
    gt_labels[0, 1, 1:] = 0
    gt_valid = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    dbg = {"pos": rng.permutation(P).astype(np.int32),
           "neg": rng.permutation(M).astype(np.int32)}
    batch = dict(image=ims, height=HS, width=WS, gt_boxes=gt_boxes,
                 gt_labels=gt_labels, gt_valid=gt_valid)

    def jax_losses(p):
        per = [jd.forward_train(
            p, jnp.asarray(ims[i]), jnp.asarray(HS[i]), jnp.asarray(WS[i]),
            jnp.asarray(gt_boxes[i]), jnp.asarray(gt_labels[i]),
            jnp.asarray(gt_valid[i]), jax.random.PRNGKey(i), JCFG,
            debug_sampler={k: jnp.asarray(v) for k, v in dbg.items()})
            for i in range(2)]
        losses = {k: (per[0][k] + per[1][k]) / 2.0 for k in per[0]}
        return losses["total_loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(
        jax_losses, has_aux=True))(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return dict(params=params, np_params=np_params, batch=batch, dbg=dbg,
                jax_losses=losses, jax_grads=grads)


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["gt_labels"] = out["gt_labels"].long()
    return out


def _port_dbg(dbg):
    return {k: torch.from_numpy(v) for k, v in dbg.items()}


def _grad_tree(model):
    """The parameters' gradients in the JAX tree layout (zeros where a
    parameter has none)."""
    saved = {n: p.data for n, p in model.named_parameters()}
    for _, p in model.named_parameters():
        p.data = p.grad if p.grad is not None else torch.zeros_like(p)
    try:
        return from_torch(model)
    finally:
        for n, p in model.named_parameters():
            p.data = saved[n]


def test_forward_train_losses_match_jax(setup):
    model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
    with torch.no_grad():
        losses = batched_loss(model, _torch_batch(setup["batch"]),
                              debug_sampler=_port_dbg(setup["dbg"]))
    assert set(losses) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k]),
                                   float(setup["jax_losses"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(losses["stats/num_pos"]) > 0
    assert float(losses["end_box_reg_loss"]) > 0


def test_gradients_match_jax(setup):
    model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
    losses = batched_loss(model, _torch_batch(setup["batch"]),
                          debug_sampler=_port_dbg(setup["dbg"]))
    losses["total_loss"].backward()
    got = _flat(_grad_tree(model))
    ref = _flat(setup["jax_grads"])
    assert set(got) == set(ref)
    for k in ref:
        if k.startswith("trunk1/"):  # cut from the graph in both packages
            assert not got[k].any() and not ref[k].any(), k
            continue
        scale = np.abs(ref[k]).max()
        assert scale > 0, f"{k}: reference gradient is all zero"
        err = np.abs(got[k] - ref[k]).max() / scale
        assert err <= 1e-3, f"{k}: relative gradient error {err:.2e}"


def _jax_step(setup):
    """One update of the JAX static-freeze optimizer with the gradient
    of the fixture (conv2 frozen: zero grads, no-op transform)."""
    params = setup["params"]
    cfg = JCFG.replace(static_freeze_cnn=True)
    tx = jts.make_optimizer(cfg, learning_rate=LR)
    zones = jts.param_zones(params)
    grads = {}
    for k, g in setup["jax_grads"].items():
        if zones[k] == "main":
            grads[k] = jax.tree_util.tree_map(
                lambda gi, pi: gi + cfg.weight_decay * pi, g, params[k])
        else:
            grads[k] = jax.tree_util.tree_map(jnp.zeros_like, g)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates), grads


def test_one_step_matches_jax(setup):
    ref_params, ref_grads = _jax_step(setup)
    model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
    trainer = Trainer(model, learning_rate=LR)
    trainer.step(_torch_batch(setup["batch"]),
                 debug_sampler=_port_dbg(setup["dbg"]))
    got = _flat(from_torch(model))
    ref = _flat(ref_params)
    g = _flat(ref_grads)
    before = _flat(setup["np_params"])
    for k in ref:
        if k.startswith(("trunk1/", "trunk2/")):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            continue
        # Adam's first update is about -lr * sign(g): where |g| is near
        # eps (or the two gradients differ in sign) the packages may
        # differ by up to 2 lr; where |g| >> eps they agree closely
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2 * LR + 1e-6, k
        big = np.abs(g[k]) > 1e-3 * np.abs(g[k]).max()
        assert diff[big].max(initial=0.0) <= 1e-3 * LR + 1e-6, k
        assert np.abs(got[k] - before[k]).max() > 0, f"{k} did not move"


def test_finetune_flip(setup):
    model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
    trainer = Trainer(model, learning_rate=LR)
    batch = _torch_batch(setup["batch"])
    dbg = _port_dbg(setup["dbg"])

    def snapshot(prefix):
        return {n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith(prefix)}

    t1, t2 = snapshot("trunk1."), snapshot("trunk2.")
    trainer.step(batch, debug_sampler=dbg)
    trainer.step(batch, debug_sampler=dbg)
    assert all(torch.equal(p, t2[n]) for n, p in snapshot("trunk2.").items())
    assert not any(p in trainer.opt.state for p in trainer.cnn)
    trainer.set_finetune(True)
    trainer.step(batch, debug_sampler=dbg)
    # trunk2's Adam state is created at the flip: its count is 1, the
    # main zone's 3
    assert all(int(trainer.opt.state[p]["step"]) == 1 for p in trainer.cnn)
    assert all(int(trainer.opt.state[p]["step"]) == 3 for p in trainer.main)
    moved = snapshot("trunk2.")
    assert all(not torch.equal(moved[n], t2[n]) for n in t2)
    assert all(torch.equal(p, t1[n]) for n, p in snapshot("trunk1.").items())
    assert all(not p.requires_grad for p in snapshot("trunk1.").values())


def test_cosine_schedule_matches_optax():
    ref = optax.cosine_decay_schedule(3e-4, 50, alpha=0.02)
    got = cosine_decay_schedule(3e-4, 50, alpha=0.02)
    for count in (0, 1, 7, 25, 49, 50, 80):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_from_torch_inverts_to_torch(setup, train):
    src = _flat(setup["np_params"])
    got = _flat(from_torch(to_torch(setup["np_params"], PCFG, "cpu",
                                    train=train)))
    assert set(got) == set(src)
    for k in src:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], src[k], err_msg=k)
