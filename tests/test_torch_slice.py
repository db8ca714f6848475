"""The inference slice end to end: the port's `forward_test_batch` against
the JAX `forward_test_batch` on the same (bridged) weights and inputs.

Two images with different extents share the 96 px canvas. TINY has 144
anchors, so the default pre-NMS top-k (6000) takes the `pre_k >= N`
branch and `test_pre_nms_topk=64` the presorted branch. `valid`, `num`
and `captions` must be identical; boxes, scores and logprobs agree to
rtol / atol 1e-4 (conv and matmul accumulation orders differ between
XLA:CPU and torch). Every slot is compared, padded ones included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.utils.checkpoint import to_torch

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=12, rnn_size=32, rnn_encoding_size=32,
            fc_dim=64, rpn_num_filters=32)
JCFG = JaxConfig(**TINY, sampler_batch_size=16, max_gt_boxes=8,
                 compute_dtype=jnp.float32)
PCFG = DenseCapConfig(**TINY, compute_dtype=torch.float32)
HS, WS = np.float32([96, 72]), np.float32([80, 96])


@pytest.fixture(scope="module")
def setup():
    params = jd.init_params(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(0)
    ims = (rng.standard_normal((2, 96, 96, 3)) * 30).astype(np.float32)
    for i in range(2):  # normalized canvases are zero past the extent
        ims[i, int(HS[i]):] = 0
        ims[i, :, int(WS[i]):] = 0
    return params, jax.tree_util.tree_map(np.asarray, params), ims


@pytest.mark.parametrize("pre_k", [6000, 64], ids=["all_anchors", "presorted"])
def test_forward_test_batch_matches_jax(setup, pre_k):
    params, np_params, ims = setup
    ref = jd.forward_test_batch(params, jnp.asarray(ims), jnp.asarray(HS),
                                jnp.asarray(WS),
                                JCFG.replace(test_pre_nms_topk=pre_k))
    model = to_torch(np_params, PCFG.replace(test_pre_nms_topk=pre_k), "cpu")
    got = model.forward_test_batch(torch.from_numpy(ims),
                                   torch.from_numpy(HS), torch.from_numpy(WS))
    for name in ("valid", "num", "captions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("boxes", "scores", "caption_logprobs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name), np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert got.captions.dtype == torch.int32
    assert 0 < int(got.num.min())


def test_canvas_equals_cropped(setup):
    """A 96x80 image on the 96 px square canvas gives the outputs of the
    same image on a 96x80 canvas (the trunk masks to the extent)."""
    _, np_params, ims = setup
    model = to_torch(np_params, PCFG, "cpu")
    h, w = torch.tensor([96.0]), torch.tensor([80.0])
    sq = model.forward_test_batch(torch.from_numpy(ims[:1]), h, w)
    rect = model.forward_test_batch(
        torch.from_numpy(np.ascontiguousarray(ims[:1, :, :80])), h, w)
    n = int(sq.num[0])
    assert n == int(rect.num[0]) and n > 0
    v = sq.valid[0]
    np.testing.assert_allclose(sq.boxes[0][v].numpy(),
                               rect.boxes[0][rect.valid[0]].numpy(), atol=1e-3)
    np.testing.assert_allclose(sq.scores[0][v].numpy(),
                               rect.scores[0][rect.valid[0]].numpy(),
                               atol=1e-3)
    assert torch.equal(sq.captions[0][v], rect.captions[0][rect.valid[0]])


def test_beam_search_not_ported(setup):
    """Beam search, which this slice once lacked, now runs: a beam of 1
    gives the greedy captions, and a beam of 3 tokens in [1, V + 1]
    (`test_torch_beamsearch.py` holds it against JAX)."""
    _, np_params, ims = setup
    model = to_torch(np_params, PCFG, "cpu")
    args = (torch.from_numpy(ims), torch.from_numpy(HS), torch.from_numpy(WS))
    greedy = model.forward_test_batch(*args)
    beam1 = model.forward_test_batch(*args, use_beam=1)
    assert torch.equal(beam1.captions, greedy.captions)
    np.testing.assert_allclose(beam1.caption_logprobs.numpy(),
                               greedy.caption_logprobs.numpy(), atol=1e-5)
    caps = model.forward_test_batch(*args, use_beam=3).captions
    assert int(caps.min()) >= 1 and int(caps.max()) <= PCFG.vocab_size + 1
