"""Image-conditioned LSTM language model: teacher-forced training and
greedy decode.

Twin of `densecap_tpu/models/lstm.py` (`_lstm_step`, `_embed`,
`_encode_image`, `_project`, `forward_train`, `get_target`,
`_greedy_decode`). Tokens: words 1..V,
START = END = V+1; the embedding has V+2 rows (token t -> row t-1) and
the projection scores V+1 classes (class j <-> token j+1). The cell is
written out by hand with torch-rnn's gate order (i, f, o, g), so
converted checkpoints split by plain row slices.
"""

from __future__ import annotations

import torch
from torch import nn

from .vgg16 import dot_f32, frozen


class LanguageModel(nn.Module):
    """Matrices (in, out), cast to the compute dtype at use; biases and
    the embedding f32."""

    def __init__(self, enc_w, enc_b, embed, Wx, Wh, b, proj_w, proj_b,
                 compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.enc_w, self.enc_b = frozen(enc_w), frozen(enc_b)
        self.embed_w = frozen(embed)
        self.Wx, self.Wh, self.b = frozen(Wx), frozen(Wh), frozen(b)
        self.proj_w, self.proj_b = frozen(proj_w), frozen(proj_b)

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
        return dot_f32(h, self.proj_w, self.compute_dtype) + self.proj_b

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

    def greedy_decode(self, vectors, seq_length):
        """(P, D) RoI codes -> tokens (P, T) int32 and logprobs (P, T) f32.

        Stops once every row has emitted END (one host read per step).
        A row's tokens after its first END are END and its logprobs there
        are 0; argmax takes the first maximum.
        """
        P = vectors.shape[0]
        T = int(seq_length)
        END = self.vocab_size + 1
        dev = vectors.device
        H = self.Wh.shape[0]
        zeros = torch.zeros((P, H), dtype=torch.float32, device=dev)
        h, c = self.lstm_step(zeros, zeros, self.encode_image(vectors))
        tok = torch.full((P,), END, dtype=torch.long, device=dev)
        seq = torch.full((P, T), END, dtype=torch.int32, device=dev)
        lps = torch.zeros((P, T), dtype=torch.float32, device=dev)
        done = torch.zeros((P,), dtype=torch.bool, device=dev)
        for t in range(T):
            if bool(done.all()):
                break
            h, c = self.lstm_step(h, c, self.embed(tok))
            scores = self.project(h)
            nxt0 = scores.argmax(dim=-1)
            lp = torch.log_softmax(scores, dim=-1).gather(
                1, nxt0[:, None])[:, 0]
            tok = torch.where(done, END, nxt0 + 1)
            seq[:, t] = tok.to(torch.int32)
            lps[:, t] = torch.where(done, 0.0, lp)
            done = done | (tok == END)
        return seq, lps


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
