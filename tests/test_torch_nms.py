"""Port plain NMS against the JAX `ops.nms.nms` and the Pallas kernel
`nms_pallas` in interpret mode. Picks and valid masks must be identical:
the IoU is computed in the same f32 order on both sides and the score
sort is stable on both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.ops.nms import nms as jax_nms
from densecap_tpu.ops.pallas.nms_kernel import nms_pallas
from densecap_tpu_torch.ops.nms import nms, nms_plain
from test_torch_kernels_gpu import threshold_ties

torch.set_num_threads(2)


def _corners(rng, n, clustered=False):
    if clustered:
        centres = rng.uniform(20, 100, (5, 2))
        xy = centres[rng.integers(0, 5, n)] + rng.normal(0, 2, (n, 2))
        wh = rng.uniform(10, 30, (n, 2))
    else:
        xy = rng.uniform(1, 100, (n, 2))
        wh = rng.uniform(1, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _case(name):
    """-> (boxes (B, N, 4), scores (B, N), valid (B, N) or None, thresh,
    max_out, presorted) for one named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        b = _corners(rng, 150)[None]
        return b, rng.permutation(150).astype(np.float32)[None], None, 0.5, 40, False
    if name == "clustered":
        b = _corners(rng, 160, clustered=True)[None]
        return b, rng.uniform(0, 1, (1, 160)).astype(np.float32), None, 0.7, 60, False
    if name == "duplicates":
        b = np.repeat(_corners(rng, 30), 3, axis=0)[None]
        return b, rng.uniform(0, 1, (1, 90)).astype(np.float32), None, 0.5, 50, False
    if name == "equal_scores":
        b = _corners(rng, 100)[None]
        s = np.round(rng.uniform(0, 1, (1, 100)), 1).astype(np.float32)
        return b, s, None, 0.3, 40, False
    if name == "valid_holes":
        b = _corners(rng, 120)[None]
        v = rng.uniform(0, 1, (1, 120)) > 0.3
        return b, rng.normal(0, 2, (1, 120)).astype(np.float32), v, 0.5, 40, False
    if name == "presorted":
        b = _corners(rng, 130)[None]
        s = np.sort(rng.uniform(0, 1, 130)).astype(np.float32)[::-1][None]
        v = np.ones((1, 130), bool)
        v[0, 110:] = False           # invalid tail
        v[0, [3, 40, 77]] = False     # and holes in the middle
        return b, s.copy(), v, 0.7, 50, True
    if name == "k_exceeds_survivors":
        b = _corners(rng, 40, clustered=True)[None]
        return b, rng.uniform(0, 1, (1, 40)).astype(np.float32), None, 0.3, 64, False
    if name.startswith("ties_"):
        # IoU exactly on the threshold and one ulp either side; the card
        # test holds K1 to nms_plain on the same set
        thresh = float(name[5:])
        b, s = threshold_ties(thresh)
        return b, s, None, thresh, b.shape[1], False
    if name == "batch3":
        b = np.stack([_corners(rng, 70, clustered=c) for c in (0, 1, 0)])
        v = rng.uniform(0, 1, (3, 70)) > 0.2
        return b, rng.normal(0, 1, (3, 70)).astype(np.float32), v, 0.6, 30, False
    raise KeyError(name)


CASES = ["random", "clustered", "duplicates", "equal_scores", "valid_holes",
         "presorted", "k_exceeds_survivors", "batch3", "ties_0.3", "ties_0.5",
         "ties_0.7"]


def _port(boxes, scores, valid, thresh, k, presorted):
    v = None if valid is None else torch.from_numpy(valid)
    return nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, k,
               valid=v, presorted=presorted)


@pytest.mark.parametrize("name", CASES)
def test_plain_nms_matches_jax(name):
    boxes, scores, valid, thresh, k, presorted = _case(name)
    idx, ok = _port(boxes, scores, valid, thresh, k, presorted)
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool
    for i in range(boxes.shape[0]):
        kw = {} if valid is None else {"valid": jnp.asarray(valid[i])}
        ref_i, ref_v = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               thresh, k, presorted=presorted, **kw)
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("name", CASES)
def test_plain_nms_matches_pallas_interpret(name):
    boxes, scores, valid, thresh, k, presorted = _case(name)
    idx, ok = _port(boxes, scores, valid, thresh, k, presorted)
    for i in range(boxes.shape[0]):
        kw = {} if valid is None else {"valid": jnp.asarray(valid[i])}
        # nms_pallas always sorts; on presorted input that sort is the
        # identity, so the picks are comparable
        ref_i, ref_v = nms_pallas(jnp.asarray(boxes[i]),
                                  jnp.asarray(scores[i]), thresh, k,
                                  tile_size=32, chunk=64, interpret=True,
                                  **kw)
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ref_i))


def test_padded_slots_hold_zero_and_tile_size_is_invisible():
    boxes, scores, valid, thresh, k, _ = _case("k_exceeds_survivors")
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), thresh, k)
    idx, ok = nms_plain(*args)
    assert 0 < int(ok.sum()) < k
    assert (idx[~ok] == 0).all()
    for tile in (8, 32, 512):
        i2, v2 = nms_plain(*args, tile_size=tile)
        assert torch.equal(i2, idx) and torch.equal(v2, ok)


def test_dispatch_rejects_other_devices():
    boxes = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        nms(boxes, torch.zeros((1, 4), device="meta"), 0.5, 2)
