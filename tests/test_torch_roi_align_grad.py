"""Gradients of the port's RoI align (plain path, CPU) against `jax.grad`
of the JAX gather `roi_align`, with respect to the features and the boxes.

The clamp-tie cases place a box so that its first grid row lands exactly
on feature row 0, or its last grid column exactly on `feat_w - 1`: the
sample position then sits on the clamp bound, where `jnp.clip` splits the
gradient 0.5 / 0.5. Tolerance 1e-5 (the JAX sample positions are f64
under the suite's x64 setting, the port's f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.ops.roi_align import roi_align as jax_roi_align
from densecap_tpu_torch.ops.roi_align import roi_align

torch.set_num_threads(2)
TOL = 1e-5

# 129 px image: (2 yc - 130) / 128 and 64.5 / 129 are exact, so the grid
# rows / columns land exactly on the feature map's border
TIE_BOXES = {
    "first_row_on_zero": (60.0, 33.0, 40.0, 64.5),   # y_norm[0] == -1
    "last_col_on_edge": (97.0, 60.0, 64.5, 40.0),    # x_norm[-1] == 1
}


def _jax_grads(feats, boxes, h, w, fh, fw, g):
    def loss(f, b):
        out = jax_roi_align(f, b, h, w, 7, 7, feat_h=fh, feat_w=fw)
        return jnp.sum(out * g)
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                          jnp.asarray(boxes))


def _port_grads(feats, boxes, hs, ws, fh, fw, g):
    f = torch.from_numpy(feats).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    out = roi_align(f, b, torch.from_numpy(hs), torch.from_numpy(ws),
                    torch.from_numpy(fh), torch.from_numpy(fw), 7, 7)
    (out * torch.from_numpy(g)).sum().backward()
    return f.grad.numpy(), b.grad.numpy()


def _check(feats, boxes, hs, ws, fh, fw, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((*boxes.shape[:2], 7, 7, feats.shape[-1])
                            ).astype(np.float32)
    df, db = _port_grads(feats, boxes, hs, ws, fh, fw, g)
    for i in range(feats.shape[0]):
        rf, rb = _jax_grads(feats[i], boxes[i], float(hs[i]), float(ws[i]),
                            int(fh[i]), int(fw[i]), g[i])
        np.testing.assert_allclose(df[i], np.asarray(rf, np.float32),
                                   rtol=TOL, atol=TOL, err_msg="d feats")
        np.testing.assert_allclose(db[i], np.asarray(rb, np.float32),
                                   rtol=TOL, atol=TOL, err_msg="d boxes")


@pytest.mark.parametrize("name", sorted(TIE_BOXES))
def test_clamp_tie_gradient_matches_jax(name):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1, 9, 9, 6)).astype(np.float32)
    boxes = np.asarray([[TIE_BOXES[name]]], np.float32)
    hs = ws = np.float32([129.0])
    fh = fw = np.int32([9])
    _check(feats, boxes, hs, ws, fh, fw, seed=1)


def _random_case(seed, B, Hf, Wf, C, dims, K=9):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, Hf, Wf, C)).astype(np.float32)
    boxes = []
    for h, w, _, _ in dims:
        xy = rng.uniform((1, 1), (w, h), (K, 2))
        # a third of the boxes reach past the image (clamped samples)
        wh = rng.uniform((4, 4), (w * 1.6, h * 1.6), (K, 2))
        boxes.append(np.concatenate([xy, wh], 1))
    hs, ws, fh, fw = (np.asarray(c) for c in zip(*dims))
    return (feats, np.stack(boxes).astype(np.float32), hs.astype(np.float32),
            ws.astype(np.float32), fh.astype(np.int32), fw.astype(np.int32))


@pytest.mark.parametrize("case", [
    (1, 12, 14, 8, [(190.0, 220.0, 12, 14)]),
    (2, 10, 10, 4, [(112.0, 144.0, 7, 9), (144.0, 80.0, 9, 5)]),
    (3, 9, 9, 5, [(144.0, 100.0, 9, 6), (80.0, 144.0, 5, 9),
                  (144.0, 144.0, 9, 9)]),
], ids=["full", "cropped_pair", "batch_of_three"])
def test_random_boxes_gradient_matches_jax(case):
    seed, Hf, Wf, C, dims = case
    _check(*_random_case(seed, len(dims), Hf, Wf, C, dims), seed=seed + 10)
