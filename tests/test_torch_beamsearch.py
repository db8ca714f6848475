"""The port's beam search against the JAX package's, on the same weights.

`LanguageModel.beamsearch` against `densecap_tpu.models.lstm.beamsearch`
for beams 1, 3 and 5, with and without the early exit: tokens identical,
logprobs within 1e-5. The cases include rows that finish at different
steps, rows that never finish, and an END logit raised so far that
finished beams, each offering B equal candidates, tie in the candidate
top-k. The port searches all rows in one batch where the JAX package
folds them the same way; `forward_test_batch(use_beam=3)` is held
against the JAX `forward_test_batch(use_beam=3)`, which vmaps one search
per image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.models import lstm as jl
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.models.lstm import LanguageModel
from densecap_tpu_torch.models.vgg16 import Linear
from densecap_tpu_torch.utils.checkpoint import to_torch

torch.set_num_threads(2)
TOL = 1e-5
LMC = jl.LMConfig(vocab_size=17, seq_length=6, input_encoding_size=20,
                  rnn_size=24, image_vector_dim=12)


def _lm_params(seed, end_bias):
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_lm(jax.random.PRNGKey(seed), LMC))
    params["proj"]["b"] = params["proj"]["b"].copy()
    params["proj"]["b"][LMC.vocab_size] = end_bias  # class V <-> END
    return params


def _port_lm(p):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return LanguageModel(t(p["img_enc"]["w"]), t(p["img_enc"]["b"]),
                         t(p["embed"]), t(p["lstm"]["Wx"]),
                         t(p["lstm"]["Wh"]), t(p["lstm"]["b"]),
                         Linear(t(p["proj"]["w"]), t(p["proj"]["b"])),
                         torch.float32)


# (weights seed, END logit bias), on logits of about +-0.1: with 0 some
# rows never end; 0.02 ends rows at many different steps; with 0.1 every
# row ends at the first step, so finished beams fill the candidate top-k
CASES = [(4, 0.0), (1, 0.02), (3, 0.1)]
# one compile per (beam, early_exit), shared by the cases
_jax_beamsearch = jax.jit(jl.beamsearch, static_argnames=(
    "cfg", "beam_size", "return_logprobs", "early_exit"))


@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "fixed"])
@pytest.mark.parametrize("beam", [1, 3, 5])
@pytest.mark.parametrize("seed,end_bias", CASES,
                         ids=["plain", "ragged_ends", "ties"])
def test_beamsearch_matches_jax(seed, end_bias, beam, early_exit):
    params = _lm_params(seed, end_bias)
    rng = np.random.default_rng(seed)
    vecs = (rng.standard_normal((12, LMC.image_vector_dim)) * 2.0
            ).astype(np.float32)
    ref_seq, ref_lps = _jax_beamsearch(
        params, jnp.asarray(vecs), cfg=LMC, beam_size=beam,
        return_logprobs=True, early_exit=early_exit)
    seq, lps, score = _port_lm(params).beamsearch(
        torch.from_numpy(vecs), LMC.seq_length, beam, early_exit=early_exit)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    np.testing.assert_allclose(lps.numpy(), np.asarray(ref_lps, np.float32),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(score.numpy(), lps.sum(1).numpy(), atol=TOL)
    assert seq.dtype == torch.int32


def test_cases_cover_ragged_and_unfinished_rows():
    """The cases above hold what they claim (at beam 3): rows that never
    end, rows ending at different steps, and every row ending at the
    first step."""
    END = LMC.vocab_size + 1
    first_end = []
    for seed, end_bias in CASES:
        rng = np.random.default_rng(seed)
        vecs = torch.from_numpy((rng.standard_normal(
            (12, LMC.image_vector_dim)) * 2.0).astype(np.float32))
        seq, _, _ = _port_lm(_lm_params(seed, end_bias)).beamsearch(
            vecs, LMC.seq_length, 3)
        ends = (seq == END).numpy()
        first_end.append(np.where(ends.any(1), ends.argmax(1), -1))
    plain, ragged, ties = first_end
    assert (plain == -1).any()
    assert len(set(ragged[ragged >= 0])) >= 3
    assert (ties == 0).all()


TINY = dict(vocab_size=20, seq_length=4, image_size=96,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=12, rnn_size=32, rnn_encoding_size=32,
            fc_dim=64, rpn_num_filters=32)
HS, WS = np.float32([96, 72]), np.float32([80, 96])


def test_forward_test_batch_beam_matches_jax():
    jcfg = JaxConfig(**TINY, compute_dtype=jnp.float32)
    params = jd.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    ims = (rng.standard_normal((2, 96, 96, 3)) * 30).astype(np.float32)
    for i in range(2):  # normalized canvases are zero past the extent
        ims[i, int(HS[i]):] = 0
        ims[i, :, int(WS[i]):] = 0
    ref = jax.jit(lambda p, x, h, w: jd.forward_test_batch(
        p, x, h, w, jcfg, use_beam=3))(params, jnp.asarray(ims),
                                       jnp.asarray(HS), jnp.asarray(WS))
    model = to_torch(jax.tree_util.tree_map(np.asarray, params),
                     DenseCapConfig(**TINY, compute_dtype=torch.float32),
                     "cpu")
    got = model.forward_test_batch(torch.from_numpy(ims),
                                   torch.from_numpy(HS), torch.from_numpy(WS),
                                   use_beam=3)
    for name in ("valid", "num", "captions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("boxes", "scores", "caption_logprobs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name), np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
