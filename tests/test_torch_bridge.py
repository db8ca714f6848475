"""The weight bridge and the port's model blocks against the JAX package.

`init_params` must give JAX's tree, names, shapes and init laws;
`to_torch` of JAX-initialised parameters must reproduce `apply_trunk`,
`apply_rpn`, `apply_recog` and `_lstm_step`. Tolerance 1e-4: the conv
and matmul accumulation orders of XLA:CPU and torch differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.models import lstm as jlstm
from densecap_tpu.models.rpn import apply_rpn
from densecap_tpu.models.vgg16 import (TRUNK1_CFG, TRUNK2_CFG, apply_recog,
                                       apply_trunk)
from densecap_tpu.utils import checkpoint as jckpt
from densecap_tpu_torch.config import PORT_ONLY, DenseCapConfig
from densecap_tpu_torch.utils.checkpoint import (init_params, load_params,
                                                 to_torch)

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=12, rnn_size=32, rnn_encoding_size=32,
            fc_dim=64, rpn_num_filters=32)
JCFG = JaxConfig(**TINY, sampler_batch_size=16, max_gt_boxes=8,
                 compute_dtype=jnp.float32)
PCFG = DenseCapConfig(**TINY, compute_dtype=torch.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def bridged():
    params = jd.init_params(jax.random.PRNGKey(0), JCFG)
    # the JAX init leaves zero biases; give them values so the checks
    # below see every bias in the graph
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32) if path[-1].key == "b" else a), params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, to_torch(np_params, PCFG, "cpu")


def test_init_params_tree_names_shapes_and_laws():
    ref = _flat(jd.init_params(jax.random.PRNGKey(0), JCFG))
    got = _flat(init_params(PCFG, seed=0))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == np.float32, k
        assert (not ref[k].any()) == (not got[k].any()), k
        if ref[k].size >= 256 and ref[k].any():
            # same law: std agrees to sampling error; uniform vs normal
            # would also show in the extreme values
            assert 0.85 < got[k].std() / ref[k].std() < 1.15, k
            assert 0.7 < (np.abs(got[k]).max() / np.abs(ref[k]).max()) < 1.4, k


def test_init_params_is_seeded():
    a, b = init_params(PCFG, 1), init_params(PCFG, 1)
    c = init_params(PCFG, 2)
    fa, fb, fc = _flat(a), _flat(b), _flat(c)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert not np.array_equal(fa["trunk1/conv1_1/w"], fc["trunk1/conv1_1/w"])


def test_load_params_reads_jax_npz(tmp_path):
    params = jd.init_params(jax.random.PRNGKey(1), JCFG)
    path = str(tmp_path / "p.npz")
    jckpt.save_params(path, params, extra={"meta": '{"vocab_size": 20}'})
    got, extra = load_params(path)
    ref = _flat(params)
    assert sorted(_flat(got)) == sorted(ref)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, ref[k])
    assert str(extra["meta"]) == '{"vocab_size": 20}'


def test_config_reads_jax_json():
    cfg = DenseCapConfig.from_json(JCFG.replace(test_pre_nms_topk=77,
                                                compute_dtype=jnp.bfloat16
                                                ).to_json())
    assert cfg.compute_dtype == torch.bfloat16
    assert cfg.test_pre_nms_topk == 77 and cfg.anchors == TINY["anchors"]
    assert cfg.field_centers == JCFG.field_centers
    jax_names = {f.name for f in dataclasses.fields(JCFG)}
    for f in dataclasses.fields(DenseCapConfig):
        if f.name in jax_names and f.name != "compute_dtype":
            assert getattr(cfg, f.name) == getattr(
                JCFG.replace(test_pre_nms_topk=77), f.name), f.name
        elif f.name not in jax_names:
            # the port's own fields (the ViTDet trunk's, GRiT's text
            # decoder's, the final NMS's cut): the JAX package's defaults
            assert f.name.startswith(PORT_ONLY), f.name
            assert getattr(cfg, f.name) == f.default, f.name
    assert DenseCapConfig.from_json(cfg.to_json()) == cfg


def test_trunk_matches_apply_trunk(bridged):
    params, model = bridged
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 96, 96, 3)) * 20).astype(np.float32)
    hs, ws = np.float32([96, 72]), np.float32([80, 96])
    got = model.features(torch.from_numpy(x), torch.from_numpy(hs),
                         torch.from_numpy(ws))
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    for i in range(2):
        y = apply_trunk(params["trunk1"], TRUNK1_CFG, jnp.asarray(x[i:i + 1]),
                        jnp.float32, valid_h=jnp.float32(hs[i]),
                        valid_w=jnp.float32(ws[i]))
        y = apply_trunk(params["trunk2"], TRUNK2_CFG, y, jnp.float32,
                        valid_h=jnp.floor(hs[i] / 4.0),
                        valid_w=jnp.floor(ws[i] / 4.0))
        ref = np.asarray(y[0])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[i] / scale, ref / scale, atol=TOL)


def test_rpn_matches_apply_rpn(bridged):
    params, model = bridged
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 6, 5, 512)).astype(np.float32)
    anchors = PCFG.anchor_tensor("cpu")
    out = model.rpn(torch.from_numpy(feats).permute(0, 3, 1, 2),
                    anchors, PCFG.field_centers)
    for i in range(2):
        ref = apply_rpn(params["rpn"], jnp.asarray(feats[i]),
                        JCFG.anchor_array(), JCFG.field_centers,
                        compute_dtype=jnp.float32)
        for name in ("boxes", "trans", "scores"):
            np.testing.assert_allclose(
                getattr(out, name)[i].numpy(), np.asarray(getattr(ref, name)),
                rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(out.anchors.numpy(),
                                   np.asarray(ref.anchors), rtol=TOL)


def test_recog_matches_apply_recog(bridged):
    params, model = bridged
    rng = np.random.default_rng(2)
    roi = rng.standard_normal((5, 7, 7, 512)).astype(np.float32)
    got = model.recog(torch.from_numpy(roi)).numpy()
    ref = np.asarray(apply_recog(params["recog"], jnp.asarray(roi),
                                 train=False, compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_lstm_blocks_match(bridged):
    params, model = bridged
    lm = params["lm"]
    rng = np.random.default_rng(3)
    h, c = (rng.standard_normal((6, 32)).astype(np.float32) for _ in "hc")
    x = rng.standard_normal((6, 32)).astype(np.float32)
    h2, c2 = model.lm.lstm_step(*(torch.from_numpy(a) for a in (h, c, x)))
    rh, rc = jlstm._lstm_step(lm["lstm"], jnp.asarray(h), jnp.asarray(c),
                              jnp.asarray(x), jnp.float32)
    np.testing.assert_allclose(h2.numpy(), np.asarray(rh), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c2.numpy(), np.asarray(rc), rtol=TOL, atol=TOL)
    tokens = np.array([1, 5, 21, 22, 0, 30])  # clamped at both ends
    np.testing.assert_array_equal(
        model.lm.embed(torch.from_numpy(tokens)).numpy(),
        np.asarray(jlstm._embed(lm, jnp.asarray(tokens))))
    codes = rng.standard_normal((6, 64)).astype(np.float32)
    np.testing.assert_allclose(
        model.lm.encode_image(torch.from_numpy(codes)).numpy(),
        np.asarray(jlstm._encode_image(lm, jnp.asarray(codes), jnp.float32)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        model.lm.project(torch.from_numpy(h)).numpy(),
        np.asarray(jlstm._project(lm, jnp.asarray(h), jnp.float32)),
        rtol=TOL, atol=TOL)
