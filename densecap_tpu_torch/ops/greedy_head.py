"""The vocab head of one greedy decode step: projection, bias, argmax and
the log-softmax at the argmax, with the step's bookkeeping.

Given the f32 LSTM state `h` (P, K) and the projection `w` (K, N), `b`
(N,), with N = V + 1 classes, one step

    scores = dot_f32(h, w, bf16) + b
    tok = where(done, END, argmax(scores) + 1)      (the first maximum)
    seq[:, t] = tok;  lps[:, t] = where(done, 0, log_softmax(scores)[tok - 1])
    done |= tok == END

  * `greedy_step`: the step from its scores, as
    `LanguageModel.greedy_decode` runs it wherever K4 does not apply;
    `greedy_head_plain`: the projection, then `greedy_step`, the
    reference K4 is held against.
  * `prepare` / `greedy_head_cuda`: kernel K4 (`cuda/greedy_head.cu`),
    one launch a step that never writes the P x N scores. `prepare` makes,
    once per decode call, W^T in bf16 padded to K4's tiles, the padded
    bias, the partials of the vocab slices and the row blocks' tickets.

It replaces no TPU kernel: the JAX package leaves this step to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .cuda import build
from .linear import dot_f32

TILE_N = 128      # vocab columns per K4 tile
CHUNK_K = 64      # K per K4 stage
MAX_CHUNKS = 16   # K4's resident rows of h: 64 G rows x 64 K chunks <= 128 KB


def greedy_step(scores, done, seq, lps, t, end):
    """One step from its (P, N) f32 scores; writes seq[:, t], lps[:, t] and
    `done` in place and returns the (P,) int64 tokens."""
    nxt0 = scores.argmax(dim=-1)
    lp = torch.log_softmax(scores, dim=-1).gather(1, nxt0[:, None])[:, 0]
    tok = torch.where(done, end, nxt0 + 1)
    seq[:, t] = tok.to(torch.int32)
    lps[:, t] = torch.where(done, 0.0, lp)
    done |= tok == end
    return tok


def greedy_head_plain(h, w, b, done, seq, lps, t, end,
                      compute_dtype=torch.bfloat16):
    """One step's head in PyTorch: `greedy_step` on dot_f32(h, w) + b."""
    return greedy_step(dot_f32(h, w, compute_dtype) + b, done, seq, lps, t,
                       end)


def plan(P, K, N, sms):
    """(G, S) of K4 for P rows, depth K, N classes on a card of `sms` SMs:
    G consumer warpgroups of 64 rows a row block (two where there are more
    than 64 rows and the rows of h fit), S vocab slices, so that the row
    blocks times S fill the SMs in one wave where they can."""
    chunks = -(-K // CHUNK_K)
    if chunks > MAX_CHUNKS:
        raise ValueError(f"greedy_head: K = {K} is over "
                         f"{MAX_CHUNKS * CHUNK_K}")
    G = 2 if P > 64 and 2 * chunks <= MAX_CHUNKS else 1
    blocks = max(1, -(-P // (64 * G)))
    tiles = -(-N // TILE_N)
    return G, max(1, min(tiles, sms // blocks))


@dataclass
class Head:
    """What K4 needs for one decode call (`prepare`)."""

    wt: torch.Tensor       # (tiles x 128, chunks x 64) bf16, W^T zero-padded
    bias: torch.Tensor     # (tiles x 128,) f32, zero-padded
    part: torch.Tensor     # (P, S, 3) f32: each slice's max, index, sum
    tickets: torch.Tensor  # (row blocks,) int32, zero between launches
    tok: torch.Tensor      # (P,) int64, the last step's tokens
    K: int
    N: int
    G: int
    S: int


def prepare(w, b, P):
    """K4's state for a decode call over P rows: `w` (K, N) and `b` (N,)
    on the card, in any float dtype (the products take W in bf16)."""
    if not w.is_cuda:
        raise ValueError("greedy_head: prepare takes CUDA tensors")
    K, N = w.shape
    if b.shape != (N,):
        raise ValueError(f"greedy_head: bias {tuple(b.shape)} for {N} "
                         f"classes")
    dev = w.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G, S = plan(P, K, N, sms)
    tiles, chunks = -(-N // TILE_N), -(-K // CHUNK_K)
    wt = torch.zeros((tiles * TILE_N, chunks * CHUNK_K),
                     dtype=torch.bfloat16, device=dev)
    wt[:N, :K] = w.detach().t()
    bias = torch.zeros(tiles * TILE_N, dtype=torch.float32, device=dev)
    bias[:N] = b.detach()
    return Head(wt=wt, bias=bias,
                part=torch.empty((P, S, 3), dtype=torch.float32, device=dev),
                tickets=torch.zeros(-(-P // (64 * G)), dtype=torch.int32,
                                    device=dev),
                tok=torch.empty(P, dtype=torch.int64, device=dev),
                K=K, N=N, G=G, S=S)


def greedy_head_cuda(head, h, done, seq, lps, t, end):
    """Kernel K4: one step's head on the card, the contract of
    `greedy_head_plain`. Returns `head.tok`, which the next step's launch
    overwrites."""
    P, T = seq.shape
    if not (h.is_cuda and h.dtype == torch.float32
            and h.shape == (head.part.shape[0], head.K)):
        raise ValueError(f"greedy_head: h must be ({head.part.shape[0]}, "
                         f"{head.K}) f32 on the card, got {h.dtype} "
                         f"{tuple(h.shape)} on {h.device}")
    if not (done.dtype == torch.bool and done.shape == (P,)
            and seq.dtype == torch.int32 and lps.dtype == torch.float32
            and lps.shape == (P, T) and done.is_contiguous()
            and seq.is_contiguous() and lps.is_contiguous()
            and P == h.shape[0] and 0 <= t < T):
        raise ValueError("greedy_head: need done (P,) bool, seq (P, T) int32 "
                         "and lps (P, T) f32, contiguous, and 0 <= t < T")
    if not all(x.device == h.device for x in (done, seq, lps, head.wt)):
        raise ValueError("greedy_head: every tensor must be on h's device")
    h = h.contiguous()
    lib = build.load()
    with torch.cuda.device(h.device):
        rc = lib.dc_greedy_head(
            h.data_ptr(), head.wt.data_ptr(), head.bias.data_ptr(), P,
            head.K, head.N, head.G, head.S, head.part.data_ptr(),
            head.tickets.data_ptr(), head.tok.data_ptr(), seq.data_ptr(),
            lps.data_ptr(), T, t, done.data_ptr(), int(end),
            torch.cuda.current_stream(h.device).cuda_stream)
    build.check(rc, "greedy_head")
    build.count_launch("greedy_head")
    return head.tok
