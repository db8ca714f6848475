"""The greedy decode's LSTM cell as one step (`ops/lstm_cell.py`) on the CPU.

`pack` permutes [Wx ; Wh] and the bias by `columns`, which inverts exactly
back to the plain layout; `step_plain`, K5's arithmetic on that packed
layout, is `embed` + `lstm_step` up to the order of the f32 sums, alone
and through a whole decode, which counts one `decode.cell_steps` a step.
`cell_on_card` sends only a bf16 greedy decode on a CUDA device to kernel
K5: the CPU, f32 compute, teacher forcing (`forward_train`) and beam search
keep `lstm_step` and never load a kernel. Kernel K5 itself is held to the
plain cell on the card (`tests/test_torch_kernels_gpu.py`).
"""

import pytest
import torch

from densecap_tpu_torch.models.lstm import LanguageModel
from densecap_tpu_torch.ops import greedy_head as gh
from densecap_tpu_torch.ops import lstm_cell as lc
from densecap_tpu_torch.ops.cuda import build
from densecap_tpu_torch.utils import profiling as prof
from test_torch_greedy_head import make_lm, vectors

BF16 = torch.bfloat16


@pytest.mark.parametrize("E, H", [(512, 512), (24, 16), (40, 67), (8, 8)])
def test_pack_inverts_to_the_plain_layout(E, H):
    """Scattering the packed rows back by `columns` gives bf16(Wx),
    bf16(Wh) and b exactly, every original column once; the padding is
    zeros; each group of 32 packed columns holds gates i, f, o, g (8
    columns each) of the same 8 units."""
    g = torch.Generator().manual_seed(E + H)
    Wx = torch.randn((E, 4 * H), generator=g)
    Wh = torch.randn((H, 4 * H), generator=g)
    b = torch.randn(4 * H, generator=g)
    wt, bias = lc.pack(Wx, Wh, b)
    Ep, Hp = -(-E // 64) * 64, -(-H // 64) * 64
    assert wt.shape == (4 * Hp, Ep + Hp) and wt.dtype == BF16
    assert bias.shape == (4 * Hp,) and bias.dtype == torch.float32
    cols = lc.columns(H)
    keep = cols >= 0
    assert sorted(cols[keep].tolist()) == list(range(4 * H))
    back_x = torch.zeros((E, 4 * H), dtype=BF16)
    back_h = torch.zeros((H, 4 * H), dtype=BF16)
    back_b = torch.zeros(4 * H)
    back_x[:, cols[keep]] = wt[keep, :E].t()
    back_h[:, cols[keep]] = wt[keep, Ep:Ep + H].t()
    back_b[cols[keep]] = bias[keep]
    assert torch.equal(back_x, Wx.to(BF16))
    assert torch.equal(back_h, Wh.to(BF16))
    assert torch.equal(back_b, b)
    assert (wt[~keep] == 0).all() and (bias[~keep] == 0).all()
    assert (wt[:, E:Ep] == 0).all() and (wt[:, Ep + H:] == 0).all()
    p = torch.arange(4 * Hp)
    gate, unit = cols // H, cols % H
    assert torch.equal(gate[keep], ((p // 8) % 4)[keep])
    assert torch.equal(unit[keep], (8 * (p // 32) + p % 8)[keep])


def _state(P, H, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((P, H), generator=g) * 2 - 1,
            (torch.rand((P, H), generator=g) * 2 - 1) * 3)


@pytest.mark.parametrize("P", [1, 7, 50])
@pytest.mark.parametrize("H", [16, 67])
def test_step_plain_is_the_plain_cell(P, H):
    """A token step from a random state (tokens 0..V+2: the clamp at both
    ends) and the image step from zero state, against `embed` +
    `lstm_step`: h and c within 1e-6 (the same bf16 products, the f32 sums
    in another order); the bf16 state is bf16(h); the buffers swap."""
    lm = make_lm(V=30, H=H, D=24, seed=P)
    h0, c0 = _state(P, H, P)
    g = torch.Generator().manual_seed(P)
    tok = torch.randint(0, 33, (P,), generator=g)
    cell = lc.prepare(lm.embed_w, lm.Wx, lm.Wh, lm.b, P)
    with torch.no_grad():
        lc.load_state(cell, h0, c0)
        want = lm.lstm_step(h0, c0, lm.embed(tok))
        got = lc.step(cell, tok=tok)
        assert got[0] is cell.h and got[1] is cell.c and cell.cur == 1
        for w, k in zip(want, got):
            assert float((w - k).abs().max()) <= 1e-6
        assert torch.equal(cell.hb[1, :, :H], cell.h.to(BF16))
        assert (cell.hb[:, :, H:] == 0).all()
        x = lm.encode_image(vectors(P, 24, P))
        zeros = torch.zeros((P, H))
        want = lm.lstm_step(zeros, zeros, x)
        fresh = lc.prepare(lm.embed_w, lm.Wx, lm.Wh, lm.b, P)
        got = lc.step(fresh, x=x)
    for w, k in zip(want, got):
        assert float((w - k).abs().max()) <= 1e-6


@pytest.mark.parametrize("P", [1, 7, 50])
@pytest.mark.parametrize("end_bias", [0.0, 0.5])
def test_packed_decode_gives_the_loops_decode(monkeypatch, P, end_bias):
    """A decode whose steps go through `lc.step` on the CPU (the K5 branch
    of `greedy_decode`, taken here by hand) gives the loop's tokens and its
    logprobs within 1e-5, and counts one `decode.cell_steps` a step run,
    the image's included: 7 when all 6 steps run, fewer when every row has
    ended early."""
    lm = make_lm(V=30, H=16, D=24, seed=P, end_bias=end_bias)
    x = vectors(P, 24, P)
    store = prof.SpanStore()
    monkeypatch.setattr(prof, "STORE", store)
    heads, step = [], gh.greedy_step
    was = prof.set_recording(True)
    try:
        with torch.no_grad():
            seq, lps = lm.greedy_decode(x, 6)
            monkeypatch.setattr(lm, "cell_on_card", lambda device: True)
            monkeypatch.setattr(gh, "greedy_step",
                                lambda *a: heads.append(1) or step(*a))
            seq_k, lps_k = lm.greedy_decode(x, 6)
    finally:
        prof.set_recording(was)
    assert torch.equal(seq, seq_k)
    assert float((lps - lps_k).abs().max()) <= 1e-5
    loop, packed = store.spans("decode")
    assert "decode.cell_steps" not in (loop.counters or {})
    assert packed.counters["decode.cell_steps"][0] == len(heads) + 1
    if end_bias == 0.0:  # END never wins: every step runs
        assert len(heads) == 6


def _refuse(*a, **kw):
    raise AssertionError("K5 was asked for off its path")


@pytest.mark.parametrize("compute_dtype", [BF16, torch.float32])
def test_dispatch(monkeypatch, compute_dtype):
    """K5 only for a bf16 decode on a CUDA device, whatever the head. On
    the CPU the greedy decode, teacher forcing and beam search run
    `lstm_step` and never prepare, launch or load a kernel."""
    lm = make_lm(V=12, H=8, D=10, seed=3, compute_dtype=compute_dtype)
    quant = make_lm(V=12, H=8, D=10, seed=3, compute_dtype=compute_dtype,
                    quant=True)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for m in (lm, quant):
        assert m.cell_on_card(cuda) == (compute_dtype == BF16)
        assert not m.cell_on_card(cpu)
    for name in ("prepare", "step", "step_plain"):
        monkeypatch.setattr(lc, name, _refuse)
    monkeypatch.setattr(build, "load", _refuse)
    before = dict(build.launches)
    v = vectors(5, 10, 3)
    with torch.no_grad():
        seq, lps = lm.greedy_decode(v, 4)
        lm.beamsearch(v, 4, 2)
    assert seq.shape == (5, 4) and torch.isfinite(lps).all()
    lm.forward_train(v, torch.randint(0, 13, (5, 3)))
    assert build.launches == before
    assert build._lib is None


def test_training_and_beams_keep_the_plain_cell(monkeypatch):
    """Where the decode would take K5 (the dispatch answering as on the
    card), teacher forcing and beam search still run `lstm_step` alone:
    their outputs are those of a model whose dispatch says no."""
    lm = make_lm(V=12, H=8, D=10, seed=4)
    v = vectors(5, 10, 4)
    seqs = torch.randint(0, 13, (5, 3))
    with torch.no_grad():
        want_train = lm.forward_train(v, seqs)
        want_beam = lm.beamsearch(v, 4, 2)
    calls = []
    real = LanguageModel.lstm_step
    monkeypatch.setattr(lm, "cell_on_card", lambda device: True)
    monkeypatch.setattr(lc, "prepare", _refuse)
    monkeypatch.setattr(lc, "step", _refuse)
    monkeypatch.setattr(lm, "lstm_step",
                        lambda *a: calls.append(1) or real(lm, *a))
    with torch.no_grad():
        got_train = lm.forward_train(v, seqs)
        got_beam = lm.beamsearch(v, 4, 2)
    assert torch.equal(got_train, want_train)
    for w, g in zip(want_beam, got_beam):
        assert torch.equal(w, g)
    assert len(calls) >= 5 + 2  # T + 2 teacher-forced, two beam steps


def test_step_refuses_what_it_cannot_take():
    lm = make_lm(V=12, H=8, D=10, seed=5)
    cell = lc.prepare(lm.embed_w, lm.Wx, lm.Wh, lm.b, 4)
    x = torch.zeros((4, 8))
    tok = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="not both"):
        lc.step(cell, x=x, tok=tok)
    with pytest.raises(ValueError, match="not both"):
        lc.step(cell)
    with pytest.raises(ValueError, match="x must be"):
        lc.step(cell, x=torch.zeros((4, 9)))
    with pytest.raises(ValueError, match="tok must be"):
        lc.step(cell, tok=tok.int())
    with pytest.raises(ValueError, match="tok must be"):
        lc.step(cell, tok=torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="are not"):
        lc.pack(lm.Wx, lm.Wh[:, :-1], lm.b)
    with pytest.raises(ValueError, match="embedding"):
        lc.prepare(lm.embed_w[:, :-1], lm.Wx, lm.Wh, lm.b, 4)
