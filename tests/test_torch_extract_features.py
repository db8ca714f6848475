"""The port's batched `extract_features` against the JAX package's
per-image `extract_features`, on the same weights and canvases.

Three images share the 96 px canvas with different extents; the third
is small enough that fewer than `max_boxes` regions survive the final
NMS. `valid` must be identical and boxes agree to rtol / atol 1e-4 on
every slot, padded ones included. Codes agree to rtol 1e-4 and an atol
of 1e-5 of their largest magnitude: fc6 sums 25 088 products, and XLA:CPU
and torch sum them in different orders, so a code near 0 differs by a
few 1e-6 of the codes' scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.utils.checkpoint import to_torch

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=40, rnn_size=32, rnn_encoding_size=32,
            fc_dim=64, rpn_num_filters=32)
HS, WS = np.float32([96, 72, 40]), np.float32([80, 96, 48])
MAX_BOXES = 20


def test_extract_features_matches_jax():
    jcfg = JaxConfig(**TINY, compute_dtype=jnp.float32)
    params = jd.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(1)
    ims = (rng.standard_normal((3, 96, 96, 3)) * 30).astype(np.float32)
    for i in range(3):  # normalized canvases are zero past the extent
        ims[i, int(HS[i]):] = 0
        ims[i, :, int(WS[i]):] = 0
    one = jax.jit(lambda p, x, h, w: jd.extract_features(
        p, x, h, w, jcfg, final_nms_thresh=0.4, max_boxes=MAX_BOXES))
    ref = [one(params, jnp.asarray(ims[i]), jnp.float32(HS[i]),
               jnp.float32(WS[i])) for i in range(3)]
    ref_boxes, ref_codes, ref_valid = (
        np.stack([np.asarray(r[j]) for r in ref]) for j in range(3))

    model = to_torch(jax.tree_util.tree_map(np.asarray, params),
                     DenseCapConfig(**TINY, compute_dtype=torch.float32),
                     "cpu")
    boxes, codes, valid = model.extract_features(
        torch.from_numpy(ims), torch.from_numpy(HS), torch.from_numpy(WS),
        final_nms_thresh=0.4, max_boxes=MAX_BOXES)
    assert boxes.shape == (3, MAX_BOXES, 4)
    assert codes.shape == (3, MAX_BOXES, TINY["fc_dim"])
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    assert int(valid[2].sum()) < MAX_BOXES <= int(valid[0].sum())
    np.testing.assert_allclose(boxes.numpy(), ref_boxes, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(codes.numpy(), ref_codes, rtol=TOL,
                               atol=1e-5 * float(np.abs(ref_codes).max()))
