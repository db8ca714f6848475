"""The attention core of a ViTDet block: softmax attention with the
decomposed relative positions of detectron2's `add_decomposed_rel_pos`.

For q, k, v (N, L, heads, d) over an (hh, ww) grid (L = hh ww, tokens
row-major) and the tables Rh (2 hh - 1, d), Rw (2 ww - 1, d), each head's
logits are

    (q_i d^-0.5) . k_j + rel_h[i, kh(j)] + rel_w[i, kw(j)]
    rel_h[i, kh] = q_i . Rh[qh(i) - kh + hh - 1]        (rel_w alike)

with the unscaled q in the relative terms, and the output is their
softmax times v.

  * `attention`: kernel K6 (`cuda/vit_attention.cu`) on the card, one
    launch (`launch`) that reads q, k and v where the qkv product left
    them, takes the two tables stacked in bf16 (`table`, which a caller
    may keep) and never writes the logits; `fold` on CPU tensors.
  * `fold`: the relative terms folded into one softmax attention product
    at scale 1, `q' = [q d^-0.5, rel_h, rel_w]` against `k' = [k,
    onehot(kh), onehot(kw)]`, in f32 on the CPU (the CPU path). On the
    card it is the port's core before K6 (cuDNN's fused attention), kept
    as the card check's yardstick; the port does not call it there.
  * `plain`: the logits written out in f32, the reference K6 is held to
    on the card.

It replaces no TPU kernel: the JAX package has no ViTDet trunk.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda import build

HEAD = 64        # the head size K6 takes
TABLE_ROWS = 64  # K6 reads [Rh ; Rw] in blocks of 64 rows
MAX_TABLE = 256  # ... and at most 256 of them
MAX_REL = 136    # floats a row of K6's rel_h | rel_w in shared memory
HEAD_ALIGN = 8   # the fused backends take head sizes in multiples of 8


def rel_table(table, size):
    """(2 size - 1, d) table -> (size, size, d): row qh, column kh holds
    table[qh - kh + size - 1] (detectron2 `get_rel_pos` at equal sizes)."""
    idx = torch.arange(size, device=table.device)
    return table[idx[:, None] - idx[None, :] + size - 1]


def plain(q, k, v, rel_h, rel_w, hw):
    """The attention in f32 with the (N, heads, L, L) logits written out;
    same contract as `attention`, the output in f32."""
    hh, ww = hw
    N, L, nh, d = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    r = qf.reshape(N, nh, hh, ww, d)
    rh = torch.einsum("bnhwc,hkc->bnhwk", r, rel_table(rel_h.float(), hh))
    rw = torch.einsum("bnhwc,wkc->bnhwk", r, rel_table(rel_w.float(), ww))
    logits = ((qf * d ** -0.5) @ kf.transpose(-1, -2)).reshape(
        N, nh, hh, ww, hh, ww)
    logits = (logits + rh[..., None] + rw[..., None, :]).reshape(N, nh, L, L)
    return (torch.softmax(logits, -1) @ vf).transpose(1, 2)


def _sdpa(q, k, v):
    """Softmax attention at scale 1: in f32 on the CPU, on the operands as
    given; by a fused backend on the card (never the math one)."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q.float(), k.float(),
                                              v.float(), scale=1.0)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, scale=1.0)


def fold(q, k, v, rel_h, rel_w, hw):
    """The attention through one softmax product at scale 1; same
    contract as `attention`, the output in f32 on the CPU.

    q' and k' are written once each, in place: q d^-0.5 and k, then the
    relative terms (q against every row of both tables in one product,
    each query's own offsets gathered from it) and the one-hot key
    positions, then zeros to a multiple of HEAD_ALIGN."""
    hh, ww = hw
    N, L, nh, d = q.shape
    cd = q.dtype
    S = hh + ww
    width = d + S + (-(d + S) % HEAD_ALIGN)
    qp, kp = q.new_empty(N, L, nh, width), k.new_empty(N, L, nh, width)
    torch.mul(q, d ** -0.5, out=qp[..., :d])
    kp[..., :d] = k
    qp[..., d + S:] = 0
    kp[..., d + S:] = 0
    tables = torch.cat([rel_h, rel_w]).to(cd)
    if q.is_cuda:
        full = q.reshape(-1, d) @ tables.t()
    else:  # widened operands, f32 sums, as dot_f32
        full = (q.reshape(-1, d).float() @ tables.float().t()).to(cd)
    full = full.view(N, hh, ww, nh, -1)
    dev = q.device
    # rel_h[.., qh, qw, head, kh] = q . Rh[qh - kh + hh - 1]; rel_w alike
    ih, iw = torch.arange(hh, device=dev), torch.arange(ww, device=dev)
    idx_h = (ih[:, None] - ih[None, :] + hh - 1)[None, :, None, None]
    off = 2 * hh - 1  # the width table's first row in `tables`
    idx_w = (iw[:, None] - iw[None, :] + ww - 1 + off)[None, None, :, None]
    q5, k5 = qp.view(N, hh, ww, nh, width), kp.view(N, hh, ww, nh, width)
    torch.gather(full, 4, idx_h.expand(N, hh, ww, nh, hh),
                 out=q5[..., d:d + hh])
    torch.gather(full, 4, idx_w.expand(N, hh, ww, nh, ww),
                 out=q5[..., d + hh:d + S])
    k5[..., d:d + hh] = torch.eye(hh, dtype=cd, device=dev)[:, None, None]
    k5[..., d + hh:d + S] = torch.eye(ww, dtype=cd, device=dev)[:, None]
    o = _sdpa(qp.transpose(1, 2), kp.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def table(rel_h, rel_w):
    """K6's (tn, 64) bf16 table: [Rh ; Rw], zero rows to a multiple of 64."""
    th, rows = rel_h.shape[0], rel_h.shape[0] + rel_w.shape[0]
    t = rel_h.new_zeros((-(-rows // TABLE_ROWS) * TABLE_ROWS, HEAD),
                        dtype=torch.bfloat16)
    t[:th] = rel_h
    t[th:rows] = rel_w
    return t


def _check(q, k, v, rel_h, rel_w, hw):
    hh, ww = hw
    N, L, nh, d = q.shape
    if not all(t.is_cuda and t.device == q.device
               for t in (k, v, rel_h, rel_w)):
        raise ValueError("vit_attention: q, k, v and the tables must be on "
                         "one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"vit_attention: K6 takes bf16 q, k, v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d != HEAD or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"vit_attention: K6 takes q, k, v of one shape "
                         f"(N, L, heads, {HEAD}), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if L != hh * ww or rel_h.shape != (2 * hh - 1, d) or \
            rel_w.shape != (2 * ww - 1, d):
        raise ValueError(f"vit_attention: a {hh} x {ww} grid needs L = "
                         f"{hh * ww} and tables ({2 * hh - 1}, {d}), "
                         f"({2 * ww - 1}, {d}); got L = {L}, "
                         f"{tuple(rel_h.shape)}, {tuple(rel_w.shape)}")
    wo = -(-hh // 4) * 4
    if 2 * (hh + ww) - 2 > MAX_TABLE or -(-(wo + ww) // 32) * 32 + 8 > MAX_REL:
        raise ValueError(f"vit_attention: K6 takes grids with hh + ww <= "
                         f"{MAX_REL - 8} and 2 (hh + ww) - 2 <= {MAX_TABLE} "
                         f"table rows; got {hh} x {ww}")
    if not (q.stride() == k.stride() == v.stride() and q.stride(3) == 1
            and all(s % 8 == 0 for s in q.stride()[:3])
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        raise ValueError(f"vit_attention: K6 reads q, k, v with one set of "
                         f"strides, the head contiguous and 16-byte aligned "
                         f"rows; got strides {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")


def attention(q, k, v, rel_h, rel_w, hw, tab=None):
    """The attention core: q, k, v (N, L, heads, d) in the compute dtype
    (token-major, as the qkv product leaves them; any strides with the
    head contiguous), the tables (2 hh - 1, d) and (2 ww - 1, d), hw =
    (hh, ww); `tab`: `table(rel_h, rel_w)` where the caller keeps it. ->
    (N, L, heads, d): on the card kernel K6 in bf16, written token-major;
    on the CPU `fold`, in f32. A CUDA input K6 does not take (d other than
    64, another dtype, a grid past its shared memory) raises."""
    if not q.is_cuda:
        return fold(q, k, v, rel_h, rel_w, hw)
    _check(q, k, v, rel_h, rel_w, hw)
    return launch(q, k, v, table(rel_h, rel_w) if tab is None else tab, hw,
                  torch.empty(q.shape, dtype=torch.bfloat16, device=q.device))


def launch(q, k, v, tab, hw, out):
    """One launch of K6 on checked operands (`attention`), its `table`
    made and its (N, L, heads, d) bf16 output allocated; -> out."""
    hh, ww = hw
    N, L, nh, d = q.shape
    lib = build.load()
    with torch.cuda.device(q.device):
        rc = lib.dc_vit_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
            tab.data_ptr(), tab.shape[0], out.data_ptr(), N, L, hh, ww, nh,
            ctypes.c_float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc == -1:
        raise ValueError(f"vit_attention: K6 does not take {N} x {nh} "
                         f"heads on a {hh} x {ww} grid (its shared memory "
                         f"or its count of query tiles)")
    build.check(rc, "vit_attention")
    build.count_launch("vit_attention")
    return out
