"""Port plain RoI align against the JAX gather `roi_align`, the golden
`roi_align_naive` and the Pallas kernel (interpret mode, f32).

Tolerances: 1e-5 against gather / naive (the same lerps; the JAX sample
positions are f64 here because the test suite enables x64, the port's
f32). 1e-4 against the Pallas tent-matrix form, which sums in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
from densecap_tpu.ops.roi_align import roi_align as jax_roi_align
from densecap_tpu.ops.roi_align import roi_align_naive
from densecap_tpu_torch.ops.roi_align import roi_align, roi_align_plain

torch.set_num_threads(2)


def _boxes(rng, n, img_h, img_w, past_edge=False):
    scale = 1.6 if past_edge else 0.6
    xy = rng.uniform((1, 1), (img_w, img_h), (n, 2))
    wh = rng.uniform((4, 4), (img_w * scale, img_h * scale), (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


def _case(name):
    """-> feats (B, Hf, Wf, C), boxes (B, K, 4), img_h, img_w (B,),
    feat_h, feat_w (B,) int."""
    rng = np.random.default_rng(["full", "cropped", "past_edge",
                                 "batch"].index(name))
    if name == "full":
        feats = rng.standard_normal((1, 12, 14, 8)).astype(np.float32)
        dims = [(190.0, 220.0, 12, 14)]
    elif name == "cropped":
        feats = rng.standard_normal((1, 10, 10, 4)).astype(np.float32)
        dims = [(112.0, 144.0, 7, 9)]
    elif name == "past_edge":
        feats = rng.standard_normal((1, 8, 8, 6)).astype(np.float32)
        dims = [(128.0, 128.0, 8, 8)]
    else:  # three images, each with its own extent on one canvas
        feats = rng.standard_normal((3, 9, 9, 5)).astype(np.float32)
        dims = [(144.0, 100.0, 9, 6), (80.0, 144.0, 5, 9),
                (144.0, 144.0, 9, 9)]
    boxes = np.stack([_boxes(rng, 11, h, w, past_edge=name == "past_edge")
                      for h, w, _, _ in dims])
    hs, ws, fh, fw = (np.asarray(c) for c in zip(*dims))
    return (feats, boxes, hs.astype(np.float32), ws.astype(np.float32),
            fh.astype(np.int32), fw.astype(np.int32))


CASES = ["full", "cropped", "past_edge", "batch"]


def _port(feats, boxes, hs, ws, fh, fw):
    return roi_align(*(torch.from_numpy(a) for a in
                       (feats, boxes, hs, ws, fh, fw)), 7, 7).numpy()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("ref_fn", [jax_roi_align, roi_align_naive],
                         ids=["gather", "naive"])
def test_plain_matches_jax(name, ref_fn):
    feats, boxes, hs, ws, fh, fw = _case(name)
    got = _port(feats, boxes, hs, ws, fh, fw)
    assert got.shape == (*boxes.shape[:2], 7, 7, feats.shape[-1])
    for i in range(feats.shape[0]):
        ref = ref_fn(jnp.asarray(feats[i]), jnp.asarray(boxes[i]),
                     float(hs[i]), float(ws[i]), 7, 7,
                     feat_h=int(fh[i]), feat_w=int(fw[i]))
        np.testing.assert_allclose(got[i], np.asarray(ref, np.float32),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_interpret(name):
    feats, boxes, hs, ws, fh, fw = _case(name)
    got = _port(feats, boxes, hs, ws, fh, fw)
    for i in range(feats.shape[0]):
        ref = roi_align_pallas(
            jnp.asarray(feats[i]), jnp.asarray(boxes[i]), float(hs[i]),
            float(ws[i]), 7, 7, feat_h=int(fh[i]), feat_w=int(fw[i]),
            tile_boxes=4, interpret=True, compute_dtype=jnp.float32)
        np.testing.assert_allclose(got[i], np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_padded_canvas_equals_cropped_map():
    feats, boxes, hs, ws, fh, fw = _case("cropped")
    crop = np.ascontiguousarray(feats[:, :fh[0], :fw[0]])
    a = _port(feats, boxes, hs, ws, fh, fw)
    b = _port(crop, boxes, hs, ws, fh, fw)
    np.testing.assert_array_equal(a, b)


def test_rejects_empty_extent():
    feats, boxes, hs, ws, fh, fw = _case("full")
    with pytest.raises(ValueError):
        roi_align_plain(*(torch.from_numpy(a) for a in
                          (feats, boxes, hs, ws, fh * 0, fw)))


@pytest.mark.parametrize("extent", ["empty_h", "empty_w", "oversized_h",
                                    "oversized_w"])
def test_dispatch_rejects_bad_extent_on_cpu(extent):
    feats, boxes, hs, ws, fh, fw = _case("batch")
    fh, fw = fh.copy(), fw.copy()
    side = fh if extent.endswith("_h") else fw
    side[1] = 0 if extent.startswith("empty") else feats.shape[1] + 1
    with pytest.raises(ValueError):
        roi_align(*(torch.from_numpy(a) for a in
                    (feats, boxes, hs, ws, fh, fw)))
