"""Port geometry ops against the JAX package: conversions, pascal IoU,
clipping, box regression, anchors and the k-major head reshape.

Tolerance rtol 1e-6 / atol 1e-5: both sides compute in f32 with the same
operation order; atol covers coordinates of a few hundred pixels. Masks
are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.ops import boxes as jb
from densecap_tpu.ops import transforms as jt
from densecap_tpu_torch.ops import boxes as tb
from densecap_tpu_torch.ops import transforms as tt

torch.set_num_threads(2)
RTOL, ATOL = 1e-6, 1e-5


def _boxes(seed, n=40, lead=()):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 140, (*lead, n, 2))
    wh = rng.uniform(0.5, 90, (*lead, n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_conversions(lead):
    b = _boxes(0, lead=lead)
    _close(tb.xcycwh_to_x1y1x2y2(torch.from_numpy(b)),
           jb.xcycwh_to_x1y1x2y2(jnp.asarray(b)))
    _close(tb.x1y1x2y2_to_xcycwh(torch.from_numpy(b)),
           jb.x1y1x2y2_to_xcycwh(jnp.asarray(b)))


@pytest.mark.parametrize("seed", [1, 2])
def test_iou_pascal(seed):
    b1 = jb.xcycwh_to_x1y1x2y2(jnp.asarray(_boxes(seed, 30, (2,))))
    b2 = jb.xcycwh_to_x1y1x2y2(jnp.asarray(_boxes(seed + 10, 17, (2,))))
    got = tb.iou_pascal(torch.tensor(np.asarray(b1)),
                        torch.tensor(np.asarray(b2)))
    _close(got, jb.iou_pascal(b1, b2))


def test_clip_boxes_values_and_mask():
    b = _boxes(3, 60, (2,))
    b[:, :5, 2:] = 0.2  # degenerate boxes come out invalid
    hs, ws = np.float32([96.0, 72.0]), np.float32([80.0, 96.0])
    got, got_valid = tb.clip_boxes(torch.from_numpy(b),
                                   torch.from_numpy(ws)[:, None],
                                   torch.from_numpy(hs)[:, None])
    for i in range(2):
        ref, ref_valid = jb.clip_boxes(
            jnp.asarray(b[i]), dict(x_min=1.0, y_min=1.0, x_max=ws[i],
                                    y_max=hs[i]), "xcycwh")
        _close(got[i], ref)
        np.testing.assert_array_equal(got_valid[i].numpy(),
                                      np.asarray(ref_valid))
    assert not got_valid.all() and got_valid.any()


def test_apply_box_transform_with_clamp():
    rng = np.random.default_rng(4)
    anchors = _boxes(4, 50)
    trans = rng.normal(0, 1, (50, 4)).astype(np.float32)
    trans[:3, 2:] = [[30.0, -25.0], [21.0, 0.0], [-40.0, 19.0]]  # +-20 clamp
    _close(tt.apply_box_transform(torch.from_numpy(anchors),
                                  torch.from_numpy(trans)),
           jt.apply_box_transform(jnp.asarray(anchors), jnp.asarray(trans)))


@pytest.mark.parametrize("hw", [(6, 5), (45, 34)])
def test_make_anchors(hw):
    anchors = np.asarray(jt.DENSECAP_ANCHORS, np.float32)
    got = tt.make_anchors(*hw, torch.from_numpy(anchors),
                          jt.VGG16_FIELD_CENTERS)
    _close(got, jt.make_anchors(*hw, jnp.asarray(anchors),
                                jt.VGG16_FIELD_CENTERS))


def test_reshape_box_features_k_major():
    rng = np.random.default_rng(5)
    k, D, H, W = 3, 4, 5, 6
    nhwc = rng.standard_normal((H, W, k * D)).astype(np.float32)
    ref = jt.reshape_box_features(jnp.asarray(nhwc), k)
    # the port takes the NCHW head output of a batch
    nchw = torch.from_numpy(nhwc).permute(2, 0, 1)[None]
    got = tt.reshape_box_features(nchw, k)
    assert got.shape == (1, k * H * W, D)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
