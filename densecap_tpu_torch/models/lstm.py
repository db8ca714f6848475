"""Image-conditioned LSTM language model: teacher-forced training, greedy
decode and beam search.

Twin of `densecap_tpu/models/lstm.py` (`_lstm_step`, `_embed`,
`_encode_image`, `_project`, `forward_train`, `get_target`,
`_greedy_decode`, `beamsearch`). Tokens: words 1..V,
START = END = V+1; the embedding has V+2 rows (token t -> row t-1) and
the projection scores V+1 classes (class j <-> token j+1). The cell is
written out by hand with torch-rnn's gate order (i, f, o, g), so
converted checkpoints split by plain row slices.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import greedy_head, lstm_cell
from ..ops.linear import Linear, dot_f32, frozen
from ..utils.profiling import count, host_read, span


class LanguageModel(nn.Module):
    """Matrices (in, out), cast to the compute dtype at use; biases and
    the embedding f32. `proj`, the vocab projection, is a `Linear` or, for
    int8 inference, a `QuantLinear`, which quantizes the f32 hidden state
    as it is (JAX `_project`). Under tensor parallelism `proj` holds this
    rank's columns of the V+1 classes and gathers the full-width scores
    (`Linear`'s shard), so the cross-entropy, softmax and argmax see all
    V+1 columns and never a padded one."""

    def __init__(self, enc_w, enc_b, embed, Wx, Wh, b, proj, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.enc_w, self.enc_b = frozen(enc_w), frozen(enc_b)
        self.embed_w = frozen(embed)
        self.Wx, self.Wh, self.b = frozen(Wx), frozen(Wh), frozen(b)
        self.proj = proj

    @property
    def vocab_size(self):
        return self.embed_w.shape[0] - 2

    def lstm_step(self, h, c, x):
        cd = self.compute_dtype
        gates = dot_f32(x, self.Wx, cd) + dot_f32(h, self.Wh, cd) + self.b
        i, f, o, g = gates.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2, c2

    def embed(self, tokens):
        idx = torch.clamp(tokens - 1, 0, self.embed_w.shape[0] - 1)
        return self.embed_w[idx]

    def encode_image(self, vectors):
        return torch.relu(dot_f32(vectors, self.enc_w, self.compute_dtype)
                          + self.enc_b)

    def project(self, h):
        return self.proj(h, self.compute_dtype)

    def forward_train(self, vectors, gt_seq):
        """Teacher forcing over T + 2 steps: (N, D) RoI codes and (N, T)
        tokens in [0, V] (0 = padding) -> (N, T + 2, V + 1) scores.

        Step 0 feeds the encoded image, step 1 START, steps 2..T+1 the gt
        tokens with 0 replaced by NULL (V + 2).
        """
        N, T = gt_seq.shape
        V = self.vocab_size
        seq = torch.cat([gt_seq.new_full((N, 1), V + 1), gt_seq], 1).long()
        seq = torch.where(seq == 0, V + 2, seq)
        xs = torch.cat([self.encode_image(vectors)[:, None],
                        self.embed(seq)], 1)
        h = c = torch.zeros((N, self.Wh.shape[0]), dtype=torch.float32,
                            device=vectors.device)
        hs = []
        for t in range(T + 2):
            h, c = self.lstm_step(h, c, xs[:, t])
            hs.append(h)
        hs = torch.stack(hs, 1)
        return self.project(hs.flatten(0, 1)).reshape(N, T + 2, -1)

    def head_on_card(self, device):
        """Whether a greedy decode on `device` takes kernel K4 for its vocab
        head: on a CUDA device, in bf16, with a full-precision projection
        that is not a tensor-parallel shard. Every other case (the CPU,
        f32 compute, int8, a shard) keeps `project` and PyTorch's argmax and
        log-softmax."""
        return (device.type == "cuda" and self.compute_dtype == torch.bfloat16
                and isinstance(self.proj, Linear) and self.proj.shard is None)

    def cell_on_card(self, device):
        """Whether a greedy decode on `device` takes kernel K5 for its LSTM
        steps: on a CUDA device, in bf16, whatever the projection. The CPU
        and f32 compute keep `embed` and `lstm_step`, as do teacher forcing
        (`forward_train`, which needs their backward) and `beamsearch`."""
        return device.type == "cuda" and self.compute_dtype == torch.bfloat16

    def greedy_decode(self, vectors, seq_length):
        """(P, D) RoI codes -> tokens (P, T) int32 and logprobs (P, T) f32.

        Stops once every row has emitted END (one host read per step).
        A row's tokens after its first END are END and its logprobs there
        are 0; argmax takes the first maximum. Where `cell_on_card`, each
        LSTM step, the image's included, is one launch of K5
        (`ops/lstm_cell.py`), counted as `decode.cell_steps`; where
        `head_on_card`, each step's head is one launch of K4
        (`ops/greedy_head.py`), counted as `decode.head_steps`.
        """
        with span("decode", vectors.device):
            P = vectors.shape[0]
            T = int(seq_length)
            END = self.vocab_size + 1
            dev = vectors.device
            H = self.Wh.shape[0]
            head = (greedy_head.prepare(self.proj.w, self.proj.b, P)
                    if self.head_on_card(dev) else None)
            cell = (lstm_cell.prepare(self.embed_w, self.Wx, self.Wh, self.b,
                                      P)
                    if self.cell_on_card(dev) else None)
            x0 = self.encode_image(vectors)
            if cell is None:
                zeros = torch.zeros((P, H), dtype=torch.float32, device=dev)
                h, c = self.lstm_step(zeros, zeros, x0)
            else:
                h, c = lstm_cell.step(cell, x=x0)
                count("decode.cell_steps")
            tok = torch.full((P,), END, dtype=torch.long, device=dev)
            seq = torch.full((P, T), END, dtype=torch.int32, device=dev)
            lps = torch.zeros((P, T), dtype=torch.float32, device=dev)
            done = torch.zeros((P,), dtype=torch.bool, device=dev)
            for t in range(T):
                if host_read("decode.reads", done.all()):
                    break
                if cell is None:
                    h, c = self.lstm_step(h, c, self.embed(tok))
                else:
                    h, c = lstm_cell.step(cell, tok=tok)
                    count("decode.cell_steps")
                if head is not None:
                    tok = greedy_head.greedy_head_cuda(head, h, done, seq, lps,
                                                       t, END)
                    count("decode.head_steps")
                else:
                    tok = greedy_head.greedy_step(self.project(h), done, seq,
                                                  lps, t, END)
            return seq, lps

    def beamsearch(self, vectors, seq_length, beam_size, early_exit=True):
        """Beam search over (P, D) RoI codes (twin of
        `densecap_tpu.models.lstm.beamsearch`).

        Returns tokens (P, T) int32, the winning beam's per-step logprobs
        (P, T) f32 and its score (P,) f32, the sum of those logprobs.
        The B beams of every row are folded into the batch, so each step
        runs on (P * B, .) matrices. As in the reference, a finished beam
        scores 0 (not -inf) for every word, and its words are 0..B-1.
        With `early_exit` the loop stops once every beam of every row
        holds END (one host read per step). A row's tokens after its
        first END are END and its logprobs there 0, so both loop forms
        give the same output, and so does one search over a whole batch
        against one search per image: steps after a row finishes only
        rewrite positions past its END.
        """
        with span("decode", vectors.device):
            P, T, B = vectors.shape[0], int(seq_length), int(beam_size)
            END = self.vocab_size + 1
            dev = vectors.device
            H = self.Wh.shape[0]
            zeros = torch.zeros((P, H), dtype=torch.float32, device=dev)
            h, c = self.lstm_step(zeros, zeros, self.encode_image(vectors))
            h, c = self.lstm_step(
                h, c, self.embed(torch.full((P,), END, device=dev)))
            beam_lp, idx0 = torch.log_softmax(self.project(h), -1).topk(B, -1)
            beams = torch.ones((P, B, T), dtype=torch.long, device=dev)
            beams[:, :, 0] = idx0 + 1
            lp_hist = torch.zeros((P, B, T), dtype=torch.float32, device=dev)
            lp_hist[:, :, 0] = beam_lp
            h = h.repeat_interleave(B, 0)
            c = c.repeat_interleave(B, 0)
            row0 = B * torch.arange(P, device=dev)[:, None]
            spare_words = torch.arange(B, device=dev)
            for t in range(1, T):
                finished = (beams == END).any(2)                  # (P, B)
                if early_exit and host_read("decode.reads",
                                        finished.all()):
                    break
                words = beams[:, :, t - 1].reshape(-1)
                h, c = self.lstm_step(h, c, self.embed(words))
                scores = self.project(h)                          # (P*B, V+1)
                # Per-beam top-k of the raw logits; log_softmax is a shift per
                # row, applied to the k survivors only. Ties among one row's
                # logits are accidental, so torch.topk's order is enough here.
                top_raw, top_words = scores.topk(B, -1)
                top_lp = (top_raw - torch.logsumexp(scores, -1, keepdim=True)
                          ).reshape(P, B, B)
                top_words = top_words.reshape(P, B, B)
                alive = ~finished[:, :, None]
                top_lp = torch.where(alive, top_lp, 0.0)
                top_words = torch.where(alive, top_words, spare_words)
                cand = (beam_lp[:, :, None] + top_lp).reshape(P, B * B)
                # Every finished beam offers B equal candidates, so ties here
                # are systematic. lax.top_k takes the lower index first among
                # ties and torch.topk promises no order, so this top-k is a
                # stable ascending sort of the negated candidates.
                neg_lp, flat = torch.sort(-cand, dim=1, stable=True)
                new_lp, flat = -neg_lp[:, :B], flat[:, :B]
                src = flat // B                                   # (P, B)
                take = src[:, :, None].expand(P, B, T)
                beams = beams.gather(1, take)
                beams[:, :, t] = top_words.reshape(P, B * B).gather(
                    1, flat) + 1
                lp_hist = lp_hist.gather(1, take)
                lp_hist[:, :, t] = new_lp - beam_lp.gather(1, src)
                beam_lp = new_lp
                rows = (src + row0).reshape(-1)
                h, c = h[rows], c[rows]
            best = beam_lp.argmax(1)
            score = beam_lp.gather(1, best[:, None])[:, 0]
            pick = best[:, None, None].expand(P, 1, T)
            seq = beams.gather(1, pick)[:, 0]
            lps = lp_hist.gather(1, pick)[:, 0]
            is_end = seq == END
            first_end = is_end.to(torch.int32).argmax(1, keepdim=True)
            after = is_end.any(1, keepdim=True) & (
                torch.arange(T, device=dev)[None] > first_end)
            return (torch.where(after, END, seq).to(torch.int32),
                    torch.where(after, 0.0, lps), score)


def get_target(gt_seq, vocab_size):
    """Cross-entropy targets (..., T + 2) for (..., T) tokens: column 0
    is 0 (the image step, masked), columns 1..T copy the tokens, and the
    first 0 in columns 1..T+1 becomes END (V + 1)."""
    zero = torch.zeros_like(gt_seq[..., :1])
    y = torch.cat([gt_seq, zero], -1)
    first_zero = (y == 0).to(torch.int32).argmax(-1, keepdim=True)
    y = y.scatter(-1, first_zero, torch.full_like(first_zero, vocab_size + 1,
                                                  dtype=y.dtype))
    return torch.cat([zero, y], -1)
