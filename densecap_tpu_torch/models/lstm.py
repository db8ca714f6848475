"""Image-conditioned LSTM language model, greedy decode only.

Twin of `densecap_tpu/models/lstm.py` (`_lstm_step`, `_embed`,
`_encode_image`, `_project`, `_greedy_decode`). Tokens: words 1..V,
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
    """Matrices (in, out) in the compute dtype; biases and the embedding f32."""

    def __init__(self, enc_w, enc_b, embed, Wx, Wh, b, proj_w, proj_b):
        super().__init__()
        self.enc_w, self.enc_b = frozen(enc_w), frozen(enc_b)
        self.embed_w = frozen(embed)
        self.Wx, self.Wh, self.b = frozen(Wx), frozen(Wh), frozen(b)
        self.proj_w, self.proj_b = frozen(proj_w), frozen(proj_b)

    @property
    def vocab_size(self):
        return self.embed_w.shape[0] - 2

    def lstm_step(self, h, c, x):
        gates = dot_f32(x, self.Wx) + dot_f32(h, self.Wh) + self.b
        i, f, o, g = gates.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2, c2

    def embed(self, tokens):
        idx = torch.clamp(tokens - 1, 0, self.embed_w.shape[0] - 1)
        return self.embed_w[idx]

    def encode_image(self, vectors):
        return torch.relu(dot_f32(vectors, self.enc_w) + self.enc_b)

    def project(self, h):
        return dot_f32(h, self.proj_w) + self.proj_b

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
