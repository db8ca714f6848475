"""The batch weight of bucketed training against the JAX package.

On the fixture of `test_torch_train_slice.py` (f32, dropout off, the
sampler pinned by debug ordinals): the port's weighted `batched_loss`
against JAX's `batched_loss`, which takes the same ordinals through its
`forward_train`; a repeat slot of weight 0 against the real images
alone; and one train step on a canvas cropped to a bucket against JAX's
on the same crop. Tolerances as in that file: losses rtol 1e-4,
gradients 1e-3 of each leaf's largest entry, parameters after a step
within 2 lr, and 1e-3 lr + 1e-6 where |g| is large.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.models import densecap as jd
from densecap_tpu.parallel import train_step as jts
from densecap_tpu_torch.parallel.train_step import Trainer, batched_loss
from densecap_tpu_torch.utils.checkpoint import from_torch, to_torch
from test_torch_train_slice import (JCFG, LOSS_KEYS, LR, PCFG, _flat,
                                    _grad_tree, _port_dbg, _torch_batch,
                                    setup)  # noqa: F401  (module fixture)

torch.set_num_threads(2)


def jax_batched_loss(params, batch, dbg, cfg=JCFG, grad=False):
    """JAX's `batched_loss` (jitted), with the sampler pinned: its
    `forward_train` takes the debug ordinals (the same for every image,
    as the port's). With `grad`: (losses, gradient of total_loss)."""
    pinned = functools.partial(
        jd.forward_train,
        debug_sampler={k: jnp.asarray(v) for k, v in dbg.items()})

    def loss(p, b):
        losses = jts.batched_loss(p, b, jax.random.PRNGKey(0), cfg)
        return losses["total_loss"], losses

    fn = jax.value_and_grad(loss, has_aux=True) if grad else loss
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts.densecap, "forward_train", pinned)
        out = jax.jit(fn)(params,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return (out[0][1], out[1]) if grad else out[1]


@pytest.mark.parametrize("weight", [[1.0, 1.0], [1.0, 0.0], [0.25, 2.0],
                                    [0.0, 0.0]])
def test_weighted_batched_loss_matches_jax(setup, weight):
    batch = dict(setup["batch"], weight=np.float32(weight))
    ref = jax_batched_loss(setup["params"], batch, setup["dbg"])
    model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
    with torch.no_grad():
        got = batched_loss(model, _torch_batch(batch),
                           debug_sampler=_port_dbg(setup["dbg"]))
    assert set(got) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _repeat_padded(batch):
    """The two images and a third slot repeating the first, weight 0."""
    out = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}
    out["weight"] = np.float32([1, 1, 0])
    return out


def test_zero_weight_repeat_changes_nothing(setup):
    dbg = _port_dbg(setup["dbg"])
    runs = []
    for batch in (setup["batch"], _repeat_padded(setup["batch"])):
        model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
        losses = batched_loss(model, _torch_batch(batch), debug_sampler=dbg)
        losses["total_loss"].backward()
        runs.append(({k: float(v.detach()) for k, v in losses.items()},
                     _flat(_grad_tree(model))))
    (l2, g2), (l3, g3) = runs
    for k in LOSS_KEYS:  # stats/num_pos included
        np.testing.assert_allclose(l3[k], l2[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    ref = _flat(setup["jax_grads"])  # JAX on the two real images
    for k in ref:
        scale = np.abs(ref[k]).max()
        if scale == 0:  # trunk1, cut from the graph
            assert not g3[k].any(), k
            continue
        for got in (g3, g2):
            err = np.abs(got[k] - ref[k]).max() / scale
            assert err <= 1e-3, f"{k}: relative gradient error {err:.2e}"


def _bucket_batch():
    """Two frames, 72x96 and 80x64, on an 80x96 canvas (a bucket of the
    96 px square), normalized, with gt boxes inside each."""
    rng = np.random.default_rng(4)
    hs, ws = np.float32([72, 80]), np.float32([96, 64])
    ims = (rng.standard_normal((2, 80, 96, 3)) * 30).astype(np.float32)
    for i in range(2):
        ims[i, int(hs[i]):] = 0
        ims[i, :, int(ws[i]):] = 0
    wh = rng.uniform(12, 32, (2, 6, 2))
    xy = rng.uniform(wh / 2 + 1, np.stack([ws, hs], -1)[:, None] - wh / 2)
    labels = rng.integers(1, 21, (2, 6, 4)).astype(np.int32)
    labels[:, :, 3] = 0
    return dict(image=ims, height=hs, width=ws,
                gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                gt_labels=labels,
                gt_valid=np.asarray([[1, 1, 1, 1, 0, 0],
                                     [1, 1, 1, 0, 0, 0]], bool))


def test_train_step_on_a_bucket_crop_matches_jax(setup):
    batch = _bucket_batch()
    params, dbg = setup["params"], setup["dbg"]
    cfg = JCFG.replace(static_freeze_cnn=True)

    ref_losses, grads = jax_batched_loss(params, batch, dbg, cfg, grad=True)
    zones = jts.param_zones(params)
    grads = {k: (jax.tree_util.tree_map(
        lambda gi, pi: gi + cfg.weight_decay * pi, g, params[k])
        if zones[k] == "main" else jax.tree_util.tree_map(jnp.zeros_like, g))
        for k, g in grads.items()}
    tx = jts.make_optimizer(cfg, learning_rate=LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = _flat(jax.tree_util.tree_map(np.asarray,
                                       jts.optax.apply_updates(params,
                                                               updates)))
    g = _flat(grads)

    model = to_torch(setup["np_params"], PCFG, "cpu", train=True)
    losses = Trainer(model, learning_rate=LR).step(
        _torch_batch(batch), debug_sampler=_port_dbg(dbg))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(losses["stats/num_pos"]) > 0
    got = _flat(from_torch(model))
    before = _flat(setup["np_params"])
    for k in ref:
        if k.startswith(("trunk1/", "trunk2/")):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            continue
        diff = np.abs(got[k] - ref[k])
        assert diff.max() <= 2 * LR + 1e-6, k
        big = np.abs(g[k]) > 1e-3 * np.abs(g[k]).max()
        assert diff[big].max(initial=0.0) <= 1e-3 * LR + 1e-6, k
