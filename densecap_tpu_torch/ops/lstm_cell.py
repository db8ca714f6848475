"""One LSTM step of the greedy decode as one launch: the embedding gather,
the gates' product and the cell's pointwise update.

For P rows, with the cell's weights Wx (E, 4H), Wh (H, 4H) and f32 bias
b (4H,) in torch-rnn's gate order (i, f, o, g), one step is

    x = embed[clamp(tok - 1, 0, rows - 1)]       (or the encoded image)
    gates = dot_f32(x, Wx, bf16) + dot_f32(h, Wh, bf16) + b
    c2 = sigmoid(f) c + sigmoid(i) tanh(g);   h2 = sigmoid(o) tanh(c2)

as `LanguageModel.embed` and `LanguageModel.lstm_step` compute it, which
stay the plain version every other path runs.

  * `prepare`: once per decode call, the `Cell`: [Wx ; Wh] transposed in
    bf16 with its gate columns permuted (`pack`), the bf16 embedding table,
    the state h and c in f32 and h in bf16 (two buffers in turns), zero.
  * `step`: kernel K5 (`cuda/lstm_cell.cu`) on the card, one launch a
    step that writes h and c and never the P x 4H gates. On CPU tensors it
    runs `step_plain`, the same arithmetic in PyTorch on the packed layout.

It replaces no TPU kernel: the JAX package leaves this step to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .cuda import build

UNITS = 64   # hidden units of a K5 tile (256 gate columns)
CHUNK = 64   # K per K5 stage


def _pad(n, to):
    return -(-n // to) * to


def columns(H, device=None):
    """The original gate column (gate H + unit) of each of the 4 Hp packed
    columns, -1 for padding (Hp = H rounded up to 64). Packed column
    32 q + 8 gate + e is gate `gate` of unit 8 q + e: each group of 32
    columns holds i, f, o and g of 8 units, so wgmma's accumulator
    fragment gives one thread all four gates of its units."""
    p = torch.arange(4 * _pad(H, UNITS), device=device)
    unit = 8 * (p // 32) + p % 8
    gate = (p // 8) % 4
    return torch.where(unit < H, gate * H + unit, -1)


def pack(Wx, Wh, b):
    """(wt, bias): [Wx ; Wh] transposed to (4 Hp, Ep + Hp) bf16, its rows
    in `columns` order and x's and h's parts each zero-padded to a
    multiple of 64; b (4H,) as (4 Hp,) f32 in the same order. Gathers
    only, no masks: nothing waits for the card."""
    E, H = Wx.shape[0], Wh.shape[0]
    if Wx.shape != (E, 4 * H) or Wh.shape != (H, 4 * H) or b.shape != (4 * H,):
        raise ValueError(f"lstm_cell: Wx {tuple(Wx.shape)}, Wh "
                         f"{tuple(Wh.shape)} and b {tuple(b.shape)} are not "
                         f"(E, 4H), (H, 4H) and (4H,)")
    Ep, Hp = _pad(E, CHUNK), _pad(H, UNITS)
    dev = Wh.device
    cols = columns(H, dev)
    src = torch.where(cols < 0, 4 * H, cols)  # padding reads a zero column

    def gathered(w):  # (n, 4H) -> (4 Hp, n) bf16 in packed order
        w = torch.cat([w.detach().to(torch.bfloat16),
                       w.new_zeros((w.shape[0], 1), dtype=torch.bfloat16)], 1)
        return w[:, src].t()

    wt = torch.zeros((4 * Hp, Ep + Hp), dtype=torch.bfloat16, device=dev)
    wt[:, :E] = gathered(Wx)
    wt[:, Ep:Ep + H] = gathered(Wh)
    bias = torch.cat([b.detach().float(), b.new_zeros(1, dtype=torch.float32)])
    return wt, bias[src]


@dataclass
class Cell:
    """What K5 needs for one decode call (`prepare`); `h` and `c` are the
    state after the last step, rewritten in place by the next."""

    wt: torch.Tensor     # (4 Hp, Ep + Hp) bf16, `pack`
    bias: torch.Tensor   # (4 Hp,) f32, `pack`
    embed: torch.Tensor  # (rows, Ep) bf16, the embedding zero-padded
    xb: torch.Tensor     # (P, Ep) bf16, the image step's x
    hb: torch.Tensor     # (2, P, Hp) bf16: bf16(h) is hb[cur]
    h: torch.Tensor      # (P, H) f32
    c: torch.Tensor      # (P, H) f32
    cur: int
    E: int


def prepare(embed_w, Wx, Wh, b, P):
    """K5's state for a decode call over P rows, h = c = 0. The weights in
    any float dtype (the products take them in bf16), on any device."""
    E, H = Wx.shape[0], Wh.shape[0]
    if embed_w.ndim != 2 or embed_w.shape[1] != E:
        raise ValueError(f"lstm_cell: embedding {tuple(embed_w.shape)} for "
                         f"inputs {E} wide")
    wt, bias = pack(Wx, Wh, b)
    Ep, Hp = _pad(E, CHUNK), _pad(H, UNITS)
    dev = Wh.device
    embed = torch.zeros((embed_w.shape[0], Ep), dtype=torch.bfloat16,
                        device=dev)
    embed[:, :E] = embed_w.detach()
    return Cell(wt=wt, bias=bias, embed=embed,
                xb=torch.zeros((P, Ep), dtype=torch.bfloat16, device=dev),
                hb=torch.zeros((2, P, Hp), dtype=torch.bfloat16, device=dev),
                h=torch.zeros((P, H), dtype=torch.float32, device=dev),
                c=torch.zeros((P, H), dtype=torch.float32, device=dev),
                cur=0, E=E)


def load_state(cell, h, c):
    """Set the cell's state to (P, H) h and c."""
    H = cell.h.shape[1]
    cell.hb[cell.cur, :, :H] = h
    cell.h.copy_(h)
    cell.c.copy_(c)


def _check(cell, x, tok):
    P = cell.h.shape[0]
    if (x is None) == (tok is None):
        raise ValueError("lstm_cell: give the step x or tok, not both")
    dev = cell.h.device
    if x is not None and not (x.shape == (P, cell.E) and x.is_floating_point()
                              and x.device == dev):
        raise ValueError(f"lstm_cell: x must be ({P}, {cell.E}) float on "
                         f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if tok is not None and not (tok.shape == (P,) and tok.dtype == torch.int64
                                and tok.device == dev
                                and tok.is_contiguous()):
        raise ValueError(f"lstm_cell: tok must be ({P},) int64 contiguous on "
                         f"{dev}, got {tok.dtype} {tuple(tok.shape)} on "
                         f"{tok.device}")


def step(cell, x=None, tok=None):
    """One LSTM step from the image's (P, E) f32 `x` or the last step's
    (P,) int64 tokens `tok`: kernel K5 on the card, `step_plain` on the
    CPU. Returns (cell.h, cell.c), which the next step overwrites."""
    _check(cell, x, tok)
    if not cell.h.is_cuda:
        return step_plain(cell, x, tok)
    P, H = cell.h.shape
    if x is not None:
        cell.xb[:, :cell.E] = x
        xsrc, tokp = cell.xb, None
    else:
        xsrc, tokp = cell.embed, tok.data_ptr()
    hb, half = cell.hb.data_ptr(), cell.hb.stride(0) * 2  # bytes a buffer
    lib = build.load()
    with torch.cuda.device(cell.h.device):
        rc = lib.dc_lstm_cell(
            xsrc.data_ptr(), xsrc.shape[0], tokp, hb + cell.cur * half,
            cell.wt.data_ptr(), cell.bias.data_ptr(), cell.c.data_ptr(),
            cell.h.data_ptr(), hb + (1 - cell.cur) * half, P, cell.E, H,
            torch.cuda.current_stream(cell.h.device).cuda_stream)
    build.check(rc, "lstm_cell")
    build.count_launch("lstm_cell")
    cell.cur ^= 1
    return cell.h, cell.c


def step_plain(cell, x=None, tok=None):
    """K5's arithmetic in PyTorch on the packed layout: one f32 product of
    bf16 [x | h] with `cell.wt`, the bias, the gates read back by
    `columns`' order, the cell's update. Same contract as `step`."""
    _check(cell, x, tok)
    P, H = cell.h.shape
    Hp = cell.hb.shape[2]
    if x is not None:
        cell.xb[:, :cell.E] = x
        xs = cell.xb
    else:
        xs = cell.embed[torch.clamp(tok - 1, 0, cell.embed.shape[0] - 1)]
    a = torch.cat([xs, cell.hb[cell.cur]], 1).float()
    gates = a @ cell.wt.float().t() + cell.bias
    # packed column 32 q + 8 gate + e -> (q, gate, e); unit 8 q + e
    i, f, o, g = (t.reshape(P, Hp)[:, :H]
                  for t in gates.view(P, Hp // 8, 4, 8).unbind(2))
    c2 = torch.sigmoid(f) * cell.c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    cell.c.copy_(c2)
    cell.h.copy_(h2)
    cell.cur ^= 1
    cell.hb[cell.cur, :, :H] = h2
    return cell.h, cell.c
