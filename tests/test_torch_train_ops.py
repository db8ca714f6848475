"""The training ops of the port against the JAX package: `iou_cwh`,
`invert_box_transform`, the six losses (values and `jax.grad` gradients,
masked rows included, rtol 1e-5), and the sampler (`compute_match_masks`
and `sample_rois` with debug ordinals: exact). The port's random draws
come from a torch Generator, not JAX's stream, so the random sampler is
checked for its invariants instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.ops import boxes as jb
from densecap_tpu.ops import losses as jl
from densecap_tpu.ops import sampler as js
from densecap_tpu.ops import transforms as jt
from densecap_tpu_torch.ops import losses as L
from densecap_tpu_torch.ops.boxes import iou_cwh
from densecap_tpu_torch.ops.sampler import compute_match_masks, sample_rois
from densecap_tpu_torch.ops.transforms import invert_box_transform

torch.set_num_threads(2)
TOL = 1e-5


def _boxes(rng, shape, lo=10.0, hi=90.0):
    xy = rng.uniform(lo, hi, (*shape, 2))
    wh = rng.uniform(4.0, 50.0, (*shape, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def test_iou_cwh_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (2, 7)), _boxes(rng, (2, 5))
    b[0, 0] = a[0, 0]  # identical boxes: IoU 1
    got = iou_cwh(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jb.iou_cwh(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, ref)
    assert abs(got[0, 0, 0] - 1.0) < 1e-6


def test_invert_box_transform_matches_jax():
    rng = np.random.default_rng(1)
    a, t = _boxes(rng, (3, 6)), _boxes(rng, (3, 6))
    t[0, :2, 2:] = 0.0  # zero-size padded rows: large but finite
    got = invert_box_transform(torch.from_numpy(a), torch.from_numpy(t))
    ref = jt.invert_box_transform(jnp.asarray(a), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL)
    assert np.isfinite(got.numpy()).all()


def _loss_cases(rng):
    """name -> (port fn, jax fn, float args, other args), batch of 2."""
    B, N = 2, 6
    valid = np.asarray([[1, 1, 1, 0, 1, 0], [0, 0, 0, 0, 0, 0]], bool)
    scores2 = rng.standard_normal((B, N, 2)).astype(np.float32) * 3
    scores1 = rng.standard_normal((B, N, 1)).astype(np.float32) * 3
    pred = rng.standard_normal((B, N, 4)).astype(np.float32) * 2
    target = rng.standard_normal((B, N, 4)).astype(np.float32) * 2
    target[0, 1, 2] = 12.0  # an outlier row
    anchors, tboxes = _boxes(rng, (B, N)), _boxes(rng, (B, N))
    tboxes[0, 2, 2] = anchors[0, 2, 2] * 3e5  # |log| > 10: outlier
    lm = rng.standard_normal((B, N, 5, 7)).astype(np.float32)
    tgt = rng.integers(0, 8, (B, N, 5))
    return {
        "cross_entropy": (L.cross_entropy, jl.cross_entropy, (scores2,),
                          (rng.integers(0, 2, (B, N)), valid)),
        "smooth_l1": (L.smooth_l1, jl.smooth_l1, (pred, target), (valid,)),
        "logistic": (L.logistic, jl.logistic, (scores1,),
                     (rng.integers(0, 2, (B, N)), valid)),
        "masked_transform_pair": (
            lambda p, t: sum(x.square().sum((-2, -1)) for x in
                             L.masked_transform_pair(p, t)),
            lambda p, t: sum(jnp.sum(jnp.square(x)) for x in
                             jl.masked_transform_pair(p, t)),
            (pred, target), ()),
        "box_regression": (
            lambda a, p, t, v: L.box_regression(a, p, t, v, weight=0.1),
            lambda a, p, t, v: jl.box_regression(a, p, t, v, weight=0.1),
            (anchors, pred), (tboxes, valid)),
        "temporal_cross_entropy": (L.temporal_cross_entropy,
                                   jl.temporal_cross_entropy, (lm,),
                                   (tgt, valid)),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases(np.random.default_rng(0))))
def test_loss_and_grad_match_jax(name):
    port_fn, jax_fn, floats, others = _loss_cases(
        np.random.default_rng(2))[name]
    targs = [torch.from_numpy(a).requires_grad_() for a in floats]
    got = port_fn(*targs, *map(torch.from_numpy, others))
    got.sum().backward()
    for i in range(2):
        def f(*fa):
            return jax_fn(*fa, *(jnp.asarray(o[i]) for o in others))
        fa = [jnp.asarray(a[i]) for a in floats]
        ref = f(*fa)
        np.testing.assert_allclose(got[i].item(), float(ref), rtol=TOL,
                                   atol=1e-6, err_msg=name)
        grads = jax.grad(f, argnums=tuple(range(len(fa))))(*fa)
        for t, g in zip(targs, grads):
            np.testing.assert_allclose(t.grad[i].numpy(), np.asarray(g),
                                       rtol=TOL, atol=1e-6, err_msg=name)
    if others:  # image 1 has no valid rows: 0 / max(0, 1)
        assert got[1].item() == 0.0


def _sampler_case(seed):
    """Two images of 40 proposals near 4 gt boxes; image 1 has gt row 3
    invalid, and a quarter of its proposals are not candidates."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, (2, 4), 25.0, 75.0)
    pick = rng.integers(0, 4, (2, 40))
    near = np.take_along_axis(gt, pick[..., None], 1)
    jitter = rng.normal(0, 1, (2, 40, 4)) * np.asarray([3, 3, 6, 6])
    inputs = (near + jitter).astype(np.float32)
    inputs[:, ::3] = _boxes(rng, (2, 14))  # far-off and random ones
    gt_valid = np.asarray([[1, 1, 1, 1], [1, 1, 1, 0]], bool)
    cand = np.ones((2, 40), bool)
    cand[1, ::4] = False
    return inputs, gt, gt_valid, cand


def _jax_masks(inputs, gt, gv, cand, low, bounds):
    return [js.compute_match_masks(
        jnp.asarray(inputs[i]), jnp.asarray(gt[i]), jnp.asarray(gv[i]),
        low_thresh=low, high_thresh=0.7,
        bounds=None if bounds is None else dict(
            x_min=1.0, y_min=1.0, x_max=float(bounds[i]),
            y_max=float(bounds[i])),
        candidate_mask=jnp.asarray(cand[i])) for i in range(2)]


@pytest.mark.parametrize("low", [0.3, 0.0], ids=["negatives", "fallback"])
@pytest.mark.parametrize("with_bounds", [False, True])
def test_match_masks_match_jax(low, with_bounds):
    inputs, gt, gv, cand = _sampler_case(3)
    bounds = np.float32([80.0, 70.0]) if with_bounds else None
    got = compute_match_masks(
        torch.from_numpy(inputs), torch.from_numpy(gt), torch.from_numpy(gv),
        low_thresh=low, high_thresh=0.7,
        bounds=None if bounds is None else dict(
            x_min=1.0, y_min=1.0, x_max=torch.from_numpy(bounds),
            y_max=torch.from_numpy(bounds)),
        candidate_mask=torch.from_numpy(cand))
    for i, ref in enumerate(_jax_masks(inputs, gt, gv, cand, low, bounds)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))
    assert bool(got[3].all()) == (low == 0.0)


def test_sample_rois_debug_ordinals_match_jax():
    inputs, gt, gv, cand = _sampler_case(4)
    bs, P = 16, 8
    dbg_pos = np.asarray([2, 0, 1, 5, 3, 7, 4, 6], np.int32)
    dbg_neg = np.arange(bs, dtype=np.int32)[::-1].copy()
    got = sample_rois(None, torch.from_numpy(inputs), torch.from_numpy(gt),
                      torch.from_numpy(gv), batch_size=bs,
                      candidate_mask=torch.from_numpy(cand),
                      debug_pos_sample_idx=torch.from_numpy(dbg_pos),
                      debug_neg_sample_idx=torch.from_numpy(dbg_neg))
    for i in range(2):
        ref = js.sample_rois(
            jax.random.PRNGKey(0), jnp.asarray(inputs[i]), jnp.asarray(gt[i]),
            jnp.asarray(gv[i]), batch_size=bs,
            candidate_mask=jnp.asarray(cand[i]),
            debug_pos_sample_idx=jnp.asarray(dbg_pos),
            debug_neg_sample_idx=jnp.asarray(dbg_neg))
        for name in ref._fields:
            g, r = getattr(got, name)[i].numpy(), np.asarray(getattr(ref, name))
            if name.endswith("_idx"):  # slots past the count alias anything
                valid = (got.pos_valid if "pos" in name else got.neg_valid)[i]
                g, r = g[valid.numpy()], r[valid.numpy()]
            np.testing.assert_array_equal(g, r, err_msg=name)
    assert 0 < int(got.num_pos.min()) and int(got.num_pos.max()) <= P


@pytest.mark.parametrize("low,bs", [(0.3, 8), (0.02, 32)],
                         ids=["plenty", "scarce"])
def test_random_sampler_invariants(low, bs):
    inputs, gt, gv, cand = _sampler_case(5)
    args = [torch.from_numpy(a) for a in (inputs, gt, gv)]
    P = bs // 2
    pos_mask, neg_mask, _, _ = compute_match_masks(
        *args, low_thresh=low, candidate_mask=torch.from_numpy(cand))
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        s = sample_rois(gen, *args, batch_size=bs, low_thresh=low,
                        candidate_mask=torch.from_numpy(cand))
        for i in range(2):
            pv, nv = s.pos_valid[i], s.neg_valid[i]
            pos = s.pos_input_idx[i][pv]
            neg = s.neg_input_idx[i][nv]
            total_pos, total_neg = int(pos_mask[i].sum()), int(neg_mask[i].sum())
            assert int(s.num_pos[i]) == min(P, total_pos) == int(pv.sum())
            assert int(nv.sum()) == bs - int(s.num_pos[i])
            assert bool(s.neg_replaced[i]) == (total_neg < int(nv.sum()))
            assert bool(pos_mask[i][pos].all()) and bool(neg_mask[i][neg].all())
            assert not set(pos.tolist()) & set(neg.tolist())
            assert len(set(pos.tolist())) == len(pos)  # no replacement
            if not s.neg_replaced[i]:
                assert len(set(neg.tolist())) == len(neg)
    assert bool(s.neg_replaced.all()) == bool(s.neg_replaced.any()) == (bs > 8)
