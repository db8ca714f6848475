"""GRiT's text decoder as DenseCap's language model (Wu, Zhang, Xiao, Liu,
Wang, Yuan, Wang, "GRiT: A Generative Region-to-text Transformer for
Object Understanding", arXiv:2212.00280, section 3.2; its
`grit/modeling/text/text_decoder.py`, `TransformerDecoderTextualHead`
over GIT's `BertEncoderAsDecoder`).

  * object tokens: each final box's features sampled on a
    `textdec_obj_pool` square grid by RoI align (K2 on the card), then
    Linear + LayerNorm to the decoder's width, `m = LN(pool(box) W_o +
    b_o)`: 196 tokens a region at 14 x 14, with no position term;
  * text tokens: `e_t = LN(E[tok_t] + P[t])`;
  * `textdec_layers` post-LN BERT layers over `[m; e]`: `h = LN1(x +
    Attn(x) W_O + b_O)`, `x' = LN2(h + GELU(h W_1 + b_1) W_2 + b_2)`
    (LayerNorm eps 1e-12, erf GELU), the attention one softmax per head
    over the keys a token may see: an object token sees the object
    tokens, a text token at position t every object token and the text
    tokens at positions <= t;
  * the logits `x_t W + b` over the V + 1 classes of the port's tokens
    (class j <-> token j + 1, END = V + 1 the last class; START is END,
    as for the LSTM).

Object tokens never see text, so their layers are an encoder whose keys
and values are fixed a region: `prefill` runs it once a call and writes
each layer's keys and values into a `KVCache`; `greedy_decode` then runs
one token a step through the layers, each layer's attention reading the
[prefix; text <= t] columns of its own layer of the cache after writing
its own. The last layer's object outputs feed nothing, so the prefill
computes only that layer's keys and values.

Precision as the ViTDet trunk's: bf16 operands and f32 accumulation; the
residual stream, LayerNorm and the softmax statistics in f32; the cache
in the compute dtype. The attention is PyTorch's
`scaled_dot_product_attention` with no mask: the prefix attends within
itself and a step reads only the columns it may see.

A step is L + 1 segments (`TextDecoder.segment`) with each layer's
attention between them. On the card in bf16, where the head is K4, the
segments replay CUDA graphs (`StepGraphs`): a decoder keeps, for the
shape it last decoded on a stream, the cache and the buffers a step
passes between its segments, and captures each text position's segments
the first time a step runs there. The attentions and K4 still run
eagerly. Everywhere else (the CPU, f32) the segments run eagerly, over a
per-call cache.

Spans (`utils.profiling`): `textdec.prefix` (the pool, the projection and
the layers over the prefix), `textdec.decode` (the loop; counters
`textdec.steps`, `decode.reads`, `decode.head_steps` for each step
whose head ran as K4, and `textdec.graph_steps` for each step replayed
from graphs) and under it `textdec.attn` (one layer's attention in a
step).
"""

from __future__ import annotations

import gc
import time

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import greedy_head
from ..ops.linear import frozen, linear_cd, linear_f32
from ..ops.roi_align import roi_align
from ..utils.profiling import count, host_read, span

LN_EPS = 1e-12
TEXTDEC_ONLY_GREEDY = ("is not supported with GRiT's text decoder: the "
                       "port runs it for greedy inference only")
TEXTDEC_TRAINING = "training " + TEXTDEC_ONLY_GREEDY
TEXTDEC_BEAM = "beam search " + TEXTDEC_ONLY_GREEDY


def is_textdec_tree(lm):
    """Whether a parameter tree's "lm" subtree is the text decoder's."""
    return "obj_proj" in lm


def layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p[0], p[1], LN_EPS)


class KVCache:
    """The keys and values of one decode call: `k` and `v` of shape
    (layers, rows, heads, prefix + steps, head dim) in the compute dtype.
    Column c < prefix holds object token c, column prefix + t text
    position t."""

    def __init__(self, layers, rows, heads, head_dim, prefix, steps, dtype,
                 device):
        shape = (layers, rows, heads, prefix + steps, head_dim)
        self.k = torch.empty(shape, dtype=dtype, device=device)
        self.v = torch.empty(shape, dtype=dtype, device=device)
        self.prefix, self.steps = prefix, steps

    @property
    def rows(self):
        return self.k.shape[1]

    def put(self, layer, col, k, v):
        """k, v (rows, heads, n, head dim) into columns col .. col + n."""
        n = k.shape[2]
        self.k[layer, :, :, col:col + n] = k
        self.v[layer, :, :, col:col + n] = v

    def upto(self, layer, n):
        """The keys and values of `layer`'s first n columns, as views."""
        return self.k[layer, :, :, :n], self.v[layer, :, :, :n]


def split_heads(y, R, L, C, heads):
    """A product (R L, n C) -> n views (R, heads, L, C / heads) of it."""
    return y.view(R, L, -1, heads, C // heads).permute(2, 0, 3, 1, 4).unbind(0)


class Layer(nn.Module):
    """One post-LN BERT layer: qkv, out, ffn1, ffn2 as (w (in, out), b);
    ln1, ln2 as (w, b)."""

    def __init__(self, qkv, out, ln1, ffn1, ffn2, ln2, heads, cd):
        super().__init__()
        self.qkv_w, self.qkv_b = frozen(qkv[0]), frozen(qkv[1])
        self.out_w, self.out_b = frozen(out[0]), frozen(out[1])
        self.ln1 = nn.ParameterList([frozen(t) for t in ln1])
        self.ffn1_w, self.ffn1_b = frozen(ffn1[0]), frozen(ffn1[1])
        self.ffn2_w, self.ffn2_b = frozen(ffn2[0]), frozen(ffn2[1])
        self.ln2 = nn.ParameterList([frozen(t) for t in ln2])
        self.heads, self.cd = heads, cd

    def qkv(self, x):
        """x (R, L, C) f32 -> q, k, v, each (R, heads, L, head dim) in the
        compute dtype (views of one product)."""
        return self._heads(x, self.qkv_w, self.qkv_b)

    def kv(self, x):
        """`qkv` without q: the product of the key and value columns."""
        C = x.shape[-1]
        return self._heads(x, self.qkv_w[:, C:], self.qkv_b[C:])

    def _heads(self, x, w, b):
        R, L, C = x.shape
        return split_heads(linear_cd(x.reshape(-1, C), w, b, self.cd), R, L,
                           C, self.heads)

    def finish(self, x, o):
        """x (R, L, C) f32 and the heads' output o (R, heads, L, head dim)
        -> the layer's output (R, L, C) f32."""
        R, L, C = x.shape
        o = o.transpose(1, 2).reshape(R * L, C)
        h = layer_norm(x.reshape(-1, C)
                       + linear_f32(o, self.out_w, self.out_b, self.cd),
                       self.ln1)
        f = F.gelu(linear_cd(h, self.ffn1_w, self.ffn1_b, self.cd))
        y = linear_f32(f, self.ffn2_w, self.ffn2_b, self.cd)
        return layer_norm(h + y, self.ln2).view(R, L, C)


class StepGraphs:
    """A decoder's graph path for one shape on one stream: the `KVCache`
    that `prefill` fills, `tok` (the tokens each step embeds, copied in
    from the head's), the buffers that cross from one segment of a step
    to the next, and each text position's segments
    (`TextDecoder.segment`) as CUDA graphs, captured on the side stream
    `side` into one memory pool in the order they replay.

    Each layer's attention runs eagerly between the segments, reading `q`
    and the cache, and its output is copied into `o`. The residual stream
    crosses in `x`, whose last value is the step's final state. `q` and
    `o` have the strides of the eager step's tensors, so a replayed
    step's attention and products run the same kernels on the same
    values as the eager step.

    Nothing here is freed between calls: the next call's prefill writes
    the cache again. The decoder's work runs on the one stream the state
    belongs to, so that write comes after this call's last step. K4's own
    state (its 47 MB transposed head at GRiT's widths) is made per call,
    after the prefill, as on the eager path: kept, it would be live
    through the next prefill's peak."""

    def __init__(self, key, dec, stream):
        rows, prefix, steps, dtype, dev = key
        C, heads = dec.words.shape[1], dec.cfg.textdec_heads
        self.key, self.stream = key, stream
        self.cache = KVCache(len(dec.layers), rows, heads, C // heads, prefix,
                             steps, dtype, dev)
        self.tok = torch.empty(rows, dtype=torch.int64, device=dev)
        self.x = torch.zeros((rows, 1, C), dtype=torch.float32, device=dev)
        self.q = split_heads(torch.zeros((rows, 3 * C), dtype=dtype,
                                         device=dev), rows, 1, C, heads)[0]
        self.o = torch.zeros((rows, 1, heads, C // heads), dtype=dtype,
                             device=dev).transpose(1, 2)
        self.side = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}      # text position -> its L + 1 segments
        self.capture_s = 0.0  # host seconds spent capturing


class TextDecoder(nn.Module):
    """The decoder: obj_proj (w (C_f, C), b), obj_ln, words (V + 1, C) and
    pos (positions, C) f32 tables, emb_ln, `Layer`s, and `proj`, the vocab
    head, an `ops.linear.Linear` (C, V + 1).

    Where the head is K4 (`head_on_card`), `prefill` hands out the cache
    of the decoder's `StepGraphs` for the call's shape on the current
    stream, and a step over that cache replays graphs. The decoder holds
    one such state, for the stream that made it; a call on another stream
    runs eagerly over a cache of its own."""

    def __init__(self, cfg, obj_proj, obj_ln, words, pos, emb_ln, layers,
                 proj):
        super().__init__()
        if cfg.seq_length > pos.shape[0]:
            raise ValueError(f"seq_length {cfg.seq_length} is over the "
                             f"text decoder's {pos.shape[0]} positions")
        self.cfg = cfg
        self.compute_dtype = cfg.compute_dtype
        self.obj_w, self.obj_b = frozen(obj_proj[0]), frozen(obj_proj[1])
        self.obj_ln = nn.ParameterList([frozen(t) for t in obj_ln])
        self.words, self.pos = frozen(words), frozen(pos)
        self.emb_ln = nn.ParameterList([frozen(t) for t in emb_ln])
        self.layers = nn.ModuleList(layers)
        self.proj = proj
        self._graphs = None  # StepGraphs

    @property
    def vocab_size(self):
        return self.words.shape[0] - 1

    def prefill(self, feats, boxes, img_h, img_w, extent, steps):
        """The prefix of every box: feats (B, Hf, Wf, C_f) f32 NHWC, boxes
        (B, M, 4) xcycwh, img_h / img_w (B,), extent (fh, fw) -> a
        `KVCache` of B M rows with room for `steps` text positions: on the
        graph path the decoder's own, which its next prefill at the shape
        overwrites."""
        cfg, cd = self.cfg, self.compute_dtype
        g = cfg.textdec_obj_pool
        with span("textdec.prefix", feats.device):
            pooled = roi_align(feats, boxes, img_h, img_w, *extent, g, g)
            R, C = pooled.shape[0] * pooled.shape[1], self.obj_w.shape[1]
            x = linear_f32(pooled.reshape(R * g * g, -1), self.obj_w,
                           self.obj_b, cd)
            x = layer_norm(x, self.obj_ln).view(R, g * g, C)
            heads = cfg.textdec_heads
            st = self._step_graphs(R, g * g, steps, feats.device)
            cache = st.cache if st is not None else KVCache(
                len(self.layers), R, heads, C // heads, g * g, steps, cd,
                feats.device)
            for i, layer in enumerate(self.layers[:-1]):
                q, k, v = layer.qkv(x)
                cache.put(i, 0, k, v)
                x = layer.finish(x, F.scaled_dot_product_attention(q, k, v))
            # the last layer's object outputs feed nothing: its k, v alone
            cache.put(len(self.layers) - 1, 0, *self.layers[-1].kv(x))
            return cache

    def _step_graphs(self, rows, prefix, steps, dev):
        """The `StepGraphs` for this shape on the current stream, made anew
        (the old one dropped) when the shape changed; None where a step
        runs eagerly: where the head is not K4, or on another stream than
        the one whose state the decoder holds."""
        if not self.head_on_card(dev):
            return None
        key = (rows, prefix, steps, self.compute_dtype, dev)
        stream = torch.cuda.current_stream(dev)
        st = self._graphs
        if st is not None:
            if st.stream != stream:
                return None
            if st.key == key:
                return st
            stream.synchronize()  # the old graphs' last replays
            self._graphs = None
        # plain tensors, which a later call outside inference mode may
        # write as well
        with torch.inference_mode(False):
            self._graphs = StepGraphs(key, self, stream)
        return self._graphs

    def _graphs_of(self, cache):
        st = self._graphs
        return st if st is not None and st.cache is cache else None

    def embed(self, tok, t):
        """(R,) tokens at text position t -> (R, C) f32."""
        e = self.words[(tok - 1).clamp(0, self.words.shape[0] - 1)]
        return layer_norm(e + self.pos[t], self.emb_ln)

    def segment(self, i, tok, x, o, t, cache):
        """Segment S_i of the step at text position t, one of L + 1 over L
        layers, which the layers' attentions separate: for i < L the
        embedding of the tokens `tok` (i = 0) or layer i - 1's `finish` of
        the residual x (R, 1, C) and the heads' output o (i > 0), then
        layer i's qkv, its keys and values written into column prefix + t
        of the cache -> (x, q); for i = L the last layer's `finish` -> (x,
        None)."""
        x = (self.embed(tok, t)[:, None] if i == 0
             else self.layers[i - 1].finish(x, o))
        if i == len(self.layers):
            return x, None
        q, k, v = self.layers[i].qkv(x)
        cache.put(i, cache.prefix + t, k, v)
        return x, q

    def attend(self, i, q, t, cache):
        """Layer i's attention at text position t: q over the columns of
        the cache up to prefix + t, in a `textdec.attn` span."""
        keys, values = cache.upto(i, cache.prefix + t + 1)
        with span("textdec.attn"):
            return F.scaled_dot_product_attention(q, keys, values)

    def step(self, tok, t, cache):
        """The tokens (R,) at text position t through every layer, each
        writing its keys and values into column prefix + t of the cache
        and attending to the columns up to it -> the final state (R, C)
        f32: the segments and the attentions between them. Over a
        `StepGraphs` cache the segments replay that position's graphs,
        and the state is the graphs' buffer, which the next step
        overwrites."""
        st = self._graphs_of(cache)
        if st is not None:
            return self._replay(st, tok, t)
        x = o = None
        for i in range(len(self.layers)):
            x, q = self.segment(i, tok, x, o, t, cache)
            o = self.attend(i, q, t, cache)
        return self.segment(len(self.layers), tok, x, o, t, cache)[0][:, 0]

    def _replay(self, st, tok, t):
        st.tok.copy_(tok)
        segments = st.graphs.get(t) or self._capture(st, t)
        for i, segment in enumerate(segments[:-1]):
            segment.replay()
            st.o.copy_(self.attend(i, st.q, t, st.cache))
        segments[-1].replay()
        count("textdec.graph_steps")
        return st.x[:, 0]

    def _capture(self, st, t):
        """Capture text position t's segments into `st`'s pool, on a side
        stream (the current one may be the default stream, where nothing
        is captured). The first capture of a state runs the segments once
        eagerly first, so that what the libraries set up on first use
        (cuBLAS's workspace on that stream) is set up outside a capture;
        the step that follows rewrites all they wrote."""
        t0 = time.perf_counter()
        here, side = torch.cuda.current_stream(st.side.device), st.side

        def run(i):
            # `segment` over the state's buffers
            x, q = self.segment(i, st.tok, st.x, st.o, t, st.cache)
            st.x.copy_(x)
            if q is not None:
                st.q.copy_(q)

        side.wait_stream(here)
        graphs = []
        # the collector may free another decoder's graphs, which no capture
        # survives; it runs after
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                if not st.graphs:
                    for i in range(len(self.layers) + 1):
                        run(i)
                    side.synchronize()
                for i in range(len(self.layers) + 1):
                    g = torch.cuda.CUDAGraph()
                    g.capture_begin(pool=st.pool,
                                    capture_error_mode="thread_local")
                    try:
                        run(i)
                    finally:
                        g.capture_end()
                    graphs.append(g)
        finally:
            if collecting:
                gc.enable()
        here.wait_stream(side)
        st.graphs[t] = graphs
        st.capture_s += time.perf_counter() - t0
        return graphs

    def project(self, x):
        return self.proj(x, self.compute_dtype)

    def head_on_card(self, device):
        """Whether a step's vocab head is kernel K4: on a CUDA device in
        bf16 (the head is always a full-precision `Linear`)."""
        return device.type == "cuda" and self.compute_dtype == torch.bfloat16

    def greedy_decode(self, cache, seq_length):
        """Greedy decode from a prefilled cache -> tokens (R, T) int32 and
        logprobs (R, T) f32, as `LanguageModel.greedy_decode` gives them:
        stops once every row has emitted END (one host read a step); a
        row's tokens after its first END are END, its logprobs there 0.
        Over a `StepGraphs` cache the steps replay graphs; the outputs are
        the call's own."""
        dev = cache.k.device
        T = int(seq_length)
        if T > cache.steps:
            raise ValueError(f"seq_length {T} is over the cache's "
                             f"{cache.steps} text positions")
        with span("textdec.decode", dev):
            P = cache.rows
            END = self.vocab_size + 1
            head = (greedy_head.prepare(self.proj.w, self.proj.b, P)
                    if self.head_on_card(dev) else None)
            tok = torch.full((P,), END, dtype=torch.long, device=dev)
            seq = torch.full((P, T), END, dtype=torch.int32, device=dev)
            lps = torch.zeros((P, T), dtype=torch.float32, device=dev)
            done = torch.zeros((P,), dtype=torch.bool, device=dev)
            for t in range(T):
                if host_read("decode.reads", done.all()):
                    break
                x = self.step(tok, t, cache)
                count("textdec.steps")
                if head is not None:
                    tok = greedy_head.greedy_head_cuda(head, x, done, seq, lps,
                                                       t, END)
                    count("decode.head_steps")
                else:
                    tok = greedy_head.greedy_step(self.project(x), done, seq,
                                                  lps, t, END)
            return seq, lps
