"""The port's int8 W8A8 inference path against the JAX package's
(`densecap_tpu/ops/quant.py`, `apply_recog`, `_project`,
`forward_test_batch` on quantized params).

  * weight codes and scales from `quantize_linear` identical, and the
    trees of `quantize_for_inference` equal leaf for leaf;
  * `qdot`: activation codes and scales identical to the jitted JAX
    `qdot` (the form the JAX model runs, where XLA multiplies by 1/127),
    outputs within rtol 1e-6, at `tests/test_quant.py`'s shapes and at
    M <= 16, K and N off a multiple of 8, zero rows and leading dims;
  * `Recog` and the vocab projection quantized against the jitted
    `apply_recog` and `_project`, in f32 and bf16;
  * a quantized `forward_test_batch` (greedy and beam 3) against the JAX
    one, to `test_torch_slice.py`'s tolerance, valid masks and tokens
    identical. A code is a rounding, so features that differ in their last
    bits (XLA's and torch's conv sums) flip a few of fc6's 25 088 codes per
    row and move the scores by ~1%. The model for this check passes its
    integer image through the trunk unchanged (each conv copies the first
    3 channels), so both quantizers see the same features;
  * `to_torch(train=True)` and dropout refuse quantized layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.models import lstm as jlstm
from densecap_tpu.models.vgg16 import apply_recog
from densecap_tpu.ops import quant as jq
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.models.vgg16 import Recog
from densecap_tpu_torch.ops import quant as pq
from densecap_tpu_torch.utils.checkpoint import to_torch

torch.set_num_threads(2)
TOL = 1e-4  # test_torch_slice.py's: conv accumulation orders differ
QTOL = 1e-6
TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=12, rnn_size=32, rnn_encoding_size=32,
            fc_dim=64, rpn_num_filters=32)
JCFG = JaxConfig(**TINY, sampler_batch_size=16, max_gt_boxes=8,
                 compute_dtype=jnp.float32)
PCFG = DenseCapConfig(**TINY, compute_dtype=torch.float32)
HS, WS = np.float32([96, 72]), np.float32([80, 96])


def _layer(rng, K, N, zero_col=True):
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    if zero_col:
        w[:, 0] = 0.0
    return {"w": w, "b": (rng.standard_normal(N) * 0.01).astype(np.float32)}


@pytest.mark.parametrize("K,N", [(64, 48), (37, 13), (25088, 512)])
def test_quantize_linear_matches_jax(K, N):
    p = _layer(np.random.default_rng(K), K, N)
    got, ref = pq.quantize_linear(p), jq.quantize_linear(p)
    assert got["w_q"].dtype == np.int8 and got["w_scale"].dtype == np.float32
    for k in ("w_q", "w_scale", "b"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert not got["w_q"][:, 0].any()


def test_quantize_for_inference_matches_jax():
    params = jax.tree_util.tree_map(
        np.asarray, jd.init_params(jax.random.PRNGKey(0), JCFG))
    for lm_proj in (False, True):
        got = pq.quantize_for_inference(params, quantize_lm_proj=lm_proj)
        ref = jq.quantize_for_inference(params, quantize_lm_proj=lm_proj)
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
        for (path, g), (_, r) in zip(flat_got, flat_ref):
            assert np.asarray(g).dtype == np.asarray(r).dtype, path
            np.testing.assert_array_equal(g, np.asarray(r), err_msg=str(path))
        assert pq.is_quantized(got["lm"]["proj"]) == lm_proj
    q = pq.quantize_for_inference(params)
    assert pq.is_quantized(q["recog"]["fc6"]) and pq.is_quantized(
        q["recog"]["fc7"])
    for name in ("trunk1", "trunk2", "rpn", "objectness", "box_reg", "lm"):
        assert q[name] is params[name]
    assert not pq.is_quantized(params["recog"]["fc6"])  # input untouched
    again = pq.quantize_for_inference(q)
    assert again["recog"]["fc6"]["w_q"] is q["recog"]["fc6"]["w_q"]


_jit_qdot = jax.jit(jq.qdot)


def _codes_times_scales(x):
    """The jitted JAX qdot against an identity layer: each activation's
    code times its row's scale, exact in f32."""
    K = x.shape[-1]
    eye = {"w_q": jnp.eye(K, dtype=jnp.int8),
           "w_scale": jnp.ones((K,), jnp.float32)}
    return np.asarray(_jit_qdot(jnp.asarray(x.reshape(-1, K)), eye))


@pytest.mark.parametrize("lead,K,N", [
    ((16,), 256, 128), ((16,), 25088, 512), ((16,), 512, 1024),  # test_quant
    ((5,), 64, 48), ((1,), 37, 13), ((300,), 100, 10001),
    ((3, 5), 32, 16)], ids=lambda v: str(v))
def test_qdot_matches_jax(lead, K, N):
    rng = np.random.default_rng(K + N)
    layer = _layer(rng, K, N)
    x = np.abs(rng.standard_normal((*lead, K))).astype(np.float32)
    x.reshape(-1, K)[0] = 0.0  # an all-zero row (a padded RoI slot)
    qj = jq.quantize_linear(layer)
    ql = pq.QuantLinear(pq.quantize_linear(layer), "cpu")
    xq, sx = pq.quantize_rows(torch.from_numpy(x.reshape(-1, K)))
    np.testing.assert_array_equal((xq.float() * sx[:, None]).numpy(),
                                  _codes_times_scales(x))
    got = pq.qdot(torch.from_numpy(x), ql).numpy()
    ref = np.asarray(_jit_qdot(jnp.asarray(x), qj))
    assert got.shape == ref.shape == (*lead, N)
    np.testing.assert_allclose(got, ref, rtol=QTOL, atol=0)


def test_qdot_codes_are_exact_and_padding_is_sliced():
    rng = np.random.default_rng(3)
    layer = pq.QuantLinear(pq.quantize_linear(_layer(rng, 37, 13)), "cpu")
    assert tuple(layer.w_qt.shape) == (16, 40)  # padded to multiples of 8
    x = torch.from_numpy(rng.standard_normal((4, 37)).astype(np.float32))
    xq, _ = pq.quantize_rows(x)
    acc = pq.int_mm(xq, layer)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (4, 13)
    w_q = layer.w_qt[:13, :37].t().long()
    assert torch.equal(acc.long(), xq.long() @ w_q)
    # a zero row quantizes to zero codes: with no bias, exact zeros out
    nob = pq.QuantLinear({k: v for k, v in pq.quantize_linear(
        _layer(rng, 32, 16)).items() if k != "b"}, "cpu")
    assert not pq.qdot(torch.zeros((4, 32)), nob).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recog_quantized_matches_apply_recog(dtype):
    rng = np.random.default_rng(5)
    C = 32
    recog = {"fc6": _layer(rng, 7 * 7 * C, 64, False),
             "fc7": _layer(rng, 64, 64, False)}
    recog["fc6"]["w"] *= 2.0
    qrecog = {k: pq.quantize_linear(v) for k, v in recog.items()}
    feats = np.abs(rng.standard_normal((9, 7, 7, C))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, f: apply_recog(
        p, f, train=False, compute_dtype=getattr(jnp, dtype)))(
            qrecog, jnp.asarray(feats)))
    model = Recog(pq.QuantLinear(qrecog["fc6"], "cpu"),
                  pq.QuantLinear(qrecog["fc7"], "cpu"), getattr(torch, dtype))
    got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, rtol=QTOL, atol=0)
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.from_numpy(feats), drop_prob=0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_quantized_matches_jax(dtype):
    params = jax.tree_util.tree_map(
        np.asarray, jd.init_params(jax.random.PRNGKey(1), JCFG))
    q = pq.quantize_for_inference(params, quantize_lm_proj=True)
    model = to_torch(q, PCFG.replace(compute_dtype=getattr(torch, dtype)),
                     "cpu")
    assert isinstance(model.lm.proj, pq.QuantLinear)
    h = np.random.default_rng(6).standard_normal((21, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jlstm._project(
        p, x, getattr(jnp, dtype)))(q["lm"], jnp.asarray(h)))
    got = model.lm.project(torch.from_numpy(h)).numpy()
    assert got.shape == (21, TINY["vocab_size"] + 1)
    np.testing.assert_allclose(got, ref, rtol=QTOL, atol=0)


def _pass_through_trunk(params):
    """Trunk convs that copy channels 0-2 (HWIO centre tap 1), bias 0: on
    an integer image every trunk value is an exact integer in both
    frameworks."""
    out = dict(params)
    for trunk in ("trunk1", "trunk2"):
        convs = {}
        for name, p in params[trunk].items():
            w = np.zeros(p["w"].shape, np.float32)
            w[1, 1, [0, 1, 2], [0, 1, 2]] = 1.0
            convs[name] = {"w": jnp.asarray(w), "b": jnp.zeros_like(p["b"])}
        out[trunk] = convs
    return out


@pytest.fixture(scope="module")
def quantized():
    params = _pass_through_trunk(jd.init_params(jax.random.PRNGKey(0), JCFG))
    qj = jq.quantize_for_inference(params)
    qp = pq.quantize_for_inference(jax.tree_util.tree_map(np.asarray,
                                                          params))
    rng = np.random.default_rng(0)
    ims = rng.integers(-120, 130, (2, 96, 96, 3)).astype(np.float32)
    for i in range(2):  # normalized canvases are zero past the extent
        ims[i, int(HS[i]):] = 0
        ims[i, :, int(WS[i]):] = 0
    return qj, qp, ims


@pytest.mark.parametrize("beam", [0, 3], ids=["greedy", "beam3"])
def test_forward_test_batch_quantized_matches_jax(quantized, beam):
    qj, qp, ims = quantized
    ref = jd.forward_test_batch(qj, jnp.asarray(ims), jnp.asarray(HS),
                                jnp.asarray(WS), JCFG, use_beam=beam)
    model = to_torch(qp, PCFG, "cpu")
    assert isinstance(model.recog.fc6, pq.QuantLinear)
    assert model.recog.fc6.w_qt.dtype == torch.int8
    assert model.recog.fc6.w_scale.dtype == model.recog.fc6.b.dtype \
        == torch.float32
    got = model.forward_test_batch(torch.from_numpy(ims),
                                   torch.from_numpy(HS), torch.from_numpy(WS),
                                   use_beam=beam)
    for name in ("valid", "num", "captions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("boxes", "scores", "caption_logprobs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name), np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert 0 < int(got.num.min())


def test_quantized_tree_is_inference_only(quantized):
    _, qp, _ = quantized
    with pytest.raises(ValueError, match="inference-only"):
        to_torch(qp, PCFG, "cpu", train=True)
    feats = torch.ones((2, 7, 7, 512))
    model = to_torch(qp, PCFG, "cpu")
    with pytest.raises(ValueError, match="inference-only"):
        model.recog(feats, drop_prob=0.5)
    assert model.recog(feats).shape == (2, TINY["fc_dim"])
