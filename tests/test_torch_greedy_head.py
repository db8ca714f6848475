"""The greedy decode's vocab head (`ops/greedy_head.py`) on the CPU.

`greedy_head_plain` is the arithmetic of `LanguageModel.greedy_decode`'s
own loop: a whole decode whose steps go through it gives exactly the
tokens and logprobs of the loop, and one step gives the first argmax, the
log-softmax there and the `done` bookkeeping, rows already done included.
`head_on_card` sends only a bf16 decode on a CUDA device with a
full-precision, unsharded projection to kernel K4; every other case keeps
the loop and never loads a kernel. `plan` fills the card's SMs. Kernel K4
itself is held to `greedy_head_plain` on the card
(`tests/test_torch_kernels_gpu.py`).
"""

import numpy as np
import pytest
import torch

from densecap_tpu_torch.models.lstm import LanguageModel
from densecap_tpu_torch.ops import greedy_head as gh
from densecap_tpu_torch.ops.cuda import build
from densecap_tpu_torch.ops.linear import Linear
from densecap_tpu_torch.ops.quant import QuantLinear, quantize_linear

BF16 = torch.bfloat16


def make_lm(V, H, D, seed, compute_dtype=BF16, end_bias=0.0, quant=False):
    """A LanguageModel by the port's init laws (`init_params`), with the
    END class's bias raised by `end_bias` so that rows finish early."""
    rng = np.random.default_rng(seed)
    hs = 1.0 / H ** 0.5

    def u(shape, scale):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    proj = {"w": u((H, V + 1), 2.0), "b": u((V + 1,), 0.1)}
    proj["b"][V] += end_bias
    t = torch.from_numpy
    wd = compute_dtype
    layer = (QuantLinear(quantize_linear(proj), torch.device("cpu")) if quant
             else Linear(t(proj["w"]).to(wd), t(proj["b"])))
    return LanguageModel(t(u((D, H), 1.0 / D ** 0.5)), t(np.zeros(H, np.float32)),
                         t(u((V + 2, H), 0.5)), t(u((H, 4 * H), hs)).to(wd),
                         t(u((H, 4 * H), hs)).to(wd),
                         t(u((4 * H,), 0.1)), layer, compute_dtype)


def vectors(P, D, seed):
    rng = np.random.default_rng(seed + 1)
    return torch.from_numpy(rng.standard_normal((P, D), dtype=np.float32))


def plain_on_the_k4_path(monkeypatch, lm):
    """Route greedy_decode's K4 branch through greedy_head_plain, on the
    CPU: the same loop, only the head differs."""
    proj = lm.proj

    def head(state, h, done, seq, lps, t, end):
        return gh.greedy_head_plain(h, proj.w, proj.b, done, seq, lps, t, end,
                                    lm.compute_dtype)

    monkeypatch.setattr(lm, "head_on_card", lambda device: True)
    monkeypatch.setattr(gh, "prepare", lambda w, b, P: "state")
    monkeypatch.setattr(gh, "greedy_head_cuda", head)


@pytest.mark.parametrize("P", [1, 7, 50])
@pytest.mark.parametrize("end_bias", [0.0, 0.5])
def test_plain_head_gives_the_loops_decode(monkeypatch, P, end_bias):
    """A decode whose heads are greedy_head_plain equals the loop's, bit
    for bit; with END's bias raised, rows finish at different steps, so
    done rows go through later heads."""
    lm = make_lm(V=30, H=16, D=24, seed=P, end_bias=end_bias)
    x = vectors(P, 24, P)
    with torch.no_grad():
        seq, lps = lm.greedy_decode(x, 6)
        plain_on_the_k4_path(monkeypatch, lm)
        seq_p, lps_p = lm.greedy_decode(x, 6)
    assert torch.equal(seq, seq_p)
    assert torch.equal(lps, lps_p)
    first_end = {int(i) for i in (seq == 31).int().argmax(1)[(seq == 31).any(1)]}
    if end_bias:  # rows end at different steps (at P = 1, at once)
        assert len(first_end) > (P > 1)
    assert seq.dtype == torch.int32 and lps.dtype == torch.float32


@pytest.mark.parametrize("P", [1, 9, 64])
@pytest.mark.parametrize("done_share", [0.0, 0.5, 1.0])
def test_plain_head_one_step(P, done_share):
    """One step against float64 numpy: the first argmax, logprob 0 and END
    on done rows, `done` raised where END is picked, only column t
    written. Small integers make every score exact in any order of the
    sums, so ties are exact: column 7 copies column 3, and many more tie
    by chance."""
    rng = np.random.default_rng(P)
    K, N, T, t = 4, 21, 5, 2
    end = N
    h = torch.from_numpy(rng.integers(-3, 4, (P, K)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, (K, N)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 9, N).astype(np.float32) / 4)
    w[:, 7], b[7] = w[:, 3], b[3]
    b[N - 1] = 6.0 if P == 9 else -40.0  # END wins some rows at P = 9
    done = torch.from_numpy(rng.uniform(size=P) < done_share)
    seq = torch.full((P, T), -1, dtype=torch.int32)
    lps = torch.full((P, T), 7.0)
    done0 = done.clone()
    tok = gh.greedy_head_plain(h, w.to(BF16), b, done, seq, lps, t, end)

    s = h.double().numpy() @ w.double().numpy() + b.double().numpy()
    arg = s.argmax(1)
    lse = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    d0 = done0.numpy()
    want_tok = np.where(d0, end, arg + 1)
    assert np.array_equal(tok.numpy(), want_tok)
    assert tok.dtype == torch.int64
    assert np.array_equal(seq[:, t].numpy(), want_tok)
    np.testing.assert_allclose(lps[:, t].numpy(),
                               np.where(d0, 0.0, s[np.arange(P), arg] - lse),
                               atol=1e-5)
    assert np.array_equal(done.numpy(), d0 | (want_tok == end))
    keep = [0, 1, 3, 4]
    assert (seq[:, keep] == -1).all() and (lps[:, keep] == 7).all()
    assert not (tok == 8).any()  # column 7 never beats its equal, 3


def _sharded(lm):
    class Shard:  # only its presence matters to the dispatch
        pass

    lm.proj.shard = Shard()
    return lm


@pytest.mark.parametrize("kind", ["linear", "f32", "int8", "shard"])
def test_dispatch(monkeypatch, kind):
    """K4 only for a bf16 decode on a CUDA device with a full-precision
    unsharded projection; every other projection or compute dtype keeps
    the loop. On the CPU every kind decodes through the loop: no kernel
    is prepared, loaded or launched."""
    lm = make_lm(V=12, H=8, D=10, seed=3,
                 compute_dtype=torch.float32 if kind == "f32" else BF16,
                 quant=kind == "int8")
    if kind == "shard":
        lm = _sharded(lm)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert lm.head_on_card(cuda) == (kind == "linear")
    assert not lm.head_on_card(cpu)
    if kind == "shard":
        return  # a shard's projection runs only inside a model group

    def refuse(*a, **kw):
        raise AssertionError("a kernel was asked for on the CPU")

    monkeypatch.setattr(gh, "prepare", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = dict(build.launches)
    with torch.no_grad():
        seq, lps = lm.greedy_decode(vectors(5, 10, 3), 4)
    assert seq.shape == (5, 4) and torch.isfinite(lps).all()
    assert build.launches == before
    assert build._lib is None


@pytest.mark.parametrize("P, K, N, want", [
    (8000, 512, 10001, (2, 2)),    # the benchmark's cell: 63 x 2 CTAs
    (8001, 512, 10001, (2, 2)),
    (1000, 512, 10001, (2, 16)),   # the CLIs at batch 1
    (50, 512, 10001, (1, 79)),     # the webcam server: one CTA a tile
    (1, 512, 10001, (1, 79)),
    (64, 512, 10001, (1, 79)),
    (65, 512, 10001, (2, 79)),
    (8000, 1024, 10001, (1, 1)),   # rows of h too wide for two groups
    (20000, 512, 10001, (2, 1)),   # more row blocks than SMs
    (0, 512, 10001, (1, 79)),
])
def test_plan(P, K, N, want):
    G, S = gh.plan(P, K, N, 132)
    assert (G, S) == want
    blocks = -(-P // (64 * G))
    assert 1 <= S <= -(-N // gh.TILE_N)
    assert blocks * S <= 132 or S == 1


def test_plan_refuses_a_deep_head():
    with pytest.raises(ValueError, match="K = 1088"):
        gh.plan(10, 1088, 100, 132)
