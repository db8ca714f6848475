"""GRiT's text decoder on ViTDet-B's DenseCap in plain PyTorch, with no
cache: the benchmark's reference for the GRiT configurations. It imports
nothing of the program and no kernel; `VitReference` supplies the ViTDet
trunk, and `Reference` under it the RPN, the RoI sampling, fc6 / fc7 and
the heads. This class adds the text decoder, its object tokens and the
whole forward with it.

The decoder follows Wu et al., "GRiT: A Generative Region-to-text
Transformer for Object Understanding" (arXiv:2212.00280, section 3.2;
`grit/modeling/text/text_decoder.py`, `TransformerDecoderTextualHead` over
GIT's `BertEncoderAsDecoder`):

  * each final box's features sampled on a `textdec_obj_pool` square
    grid (14 x 14), a Linear to the decoder's width and a LayerNorm: the
    object tokens, with no position term;
  * each text token's word embedding plus its position's, then a
    LayerNorm;
  * `textdec_layers` post-LN BERT layers over [object tokens; text
    tokens], LayerNorm eps 1e-12, erf GELU, one softmax per head over
    the keys the mask allows: an object token sees the object tokens, a
    text token at position t every object token and the text tokens at
    positions <= t;
  * the logits of each text position's final state through the vocab
    head `lm/proj`, over V + 1 classes.

`teacher_logits` runs that whole masked forward over [object tokens;
START and the served tokens] for each row, in blocks of rows, and reads
the logits at every text position; `greedy` decodes by running it again
at every step.

Departures from GRiT: the tokens are the port's (class j <-> token j + 1,
END the last class, START the same token as END), where GRiT starts with
BERT's [CLS] and ends on [SEP] of BERT's table; the object features are
sampled by DenseCap's bilinear RoI sampling from ViTDet's stride-16 map
(the configuration's one level) rather than by detectron2's ROIAlign over
the feature pyramid; the head is untied from the word table; the weights
are random from the seed.

`precision` "f32" is plain float32 with TF32 off: the caller sets the
backends' flags (`densecap_ref.f32_math`), as the drivers and the control
do. "fp8" rounds every operand of every product here too, the
attention's two included.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from .densecap_ref import Reference, box_transform, greedy_nms, to_x1y1x2y2
from .vitdet_ref import VitReference

LN_EPS = 1e-12


def layer_norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p["w"] + p["b"]


def allowed(prefix, text, device, prefix_mask=True):
    """(S, S) bool, S = prefix + text: which key each token may see.
    Without `prefix_mask` the object tokens see the text tokens too (a
    control the cached program has to disagree with)."""
    S = prefix + text
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = (j < prefix) | ((i >= prefix) & (j <= i))
    if not prefix_mask:
        ok = ok | (i < prefix)
    return ok


class GritReference(VitReference):
    """DenseCap with a ViTDet trunk and GRiT's text decoder under "lm",
    from a weight tree (`benchlib.grit.GritWeights.tree`)."""

    def __init__(self, tree, cfg, precision="f32", prefix_mask=True):
        super().__init__(tree, cfg, precision)
        self.prefix_mask = prefix_mask

    def object_features(self, feats, boxes, h, w):
        """(C, Hf, Wf) features and (n, 4) xcycwh boxes -> (n, g, g, C),
        `Reference.roi_align` on a g x g grid, g = textdec_obj_pool."""
        g = self.cfg["textdec_obj_pool"]
        grid = types.SimpleNamespace(cfg=dict(self.cfg, output_height=g,
                                              output_width=g))
        return Reference.roi_align(grid, feats, boxes, h, w)

    def layer(self, x, p, ok):
        """One post-LN layer over x (n, S, C) under the mask ok (S, S)."""
        q_ = self.q
        n, S, C = x.shape
        heads = self.cfg["textdec_heads"]
        d = C // heads
        qkv = self.mm(x.reshape(-1, C), p["qkv"]["w"], p["qkv"]["b"])
        q, k, v = qkv.reshape(n, S, 3, heads, d).permute(2, 0, 3, 1, 4)
        logits = (q_(q) @ q_(k).transpose(-1, -2)) * d ** -0.5
        logits = logits.masked_fill(~ok, -torch.inf)
        o = q_(torch.softmax(logits, -1)) @ q_(v)
        o = o.transpose(1, 2).reshape(-1, C)
        h = layer_norm(x.reshape(-1, C)
                       + self.mm(o, p["out"]["w"], p["out"]["b"]), p["ln1"])
        f = F.gelu(self.mm(h, p["ffn1"]["w"], p["ffn1"]["b"]))
        return layer_norm(h + self.mm(f, p["ffn2"]["w"], p["ffn2"]["b"]),
                          p["ln2"]).reshape(n, S, C)

    def text_states(self, obj, tokens):
        """obj (n, g, g, C_f) object features, tokens (n, L) the text
        positions' inputs -> their final states (n, L, C)."""
        lm = self.p["lm"]
        n, L = tokens.shape
        m = self.mm(obj.reshape(-1, obj.shape[-1]), lm["obj_proj"]["w"],
                    lm["obj_proj"]["b"])
        m = layer_norm(m, lm["obj_ln"]).reshape(n, -1, m.shape[-1])
        E = lm["words"]
        e = E[(tokens.long() - 1).clamp(0, E.shape[0] - 1)] + lm["pos"][:L]
        x = torch.cat([m, layer_norm(e, lm["emb_ln"])], 1)
        ok = allowed(m.shape[1], L, x.device, self.prefix_mask)
        for i in range(self.cfg["textdec_layers"]):
            x = self.layer(x, lm[f"layer{i}"], ok)
        return x[:, m.shape[1]:]

    def teacher_logits(self, obj, tokens, block=32):
        """The logits (n, T, V + 1) at each step of decoding `tokens` (n, T)
        from the object features obj (n, g, g, C_f): step t's input is the
        token of step t - 1 (START first)."""
        n, T = tokens.shape
        start = torch.full((n, 1), self.V + 1, dtype=torch.long,
                           device=tokens.device)
        inputs = torch.cat([start, tokens[:, :T - 1].long()], 1)
        out = [self.logits(self.text_states(obj[s:s + block],
                                            inputs[s:s + block]))
               for s in range(0, n, block)]
        return (torch.cat(out) if out
                else obj.new_zeros(0, T, self.V + 1))

    def greedy(self, obj, T):
        """Greedy decode -> tokens (n, T) and their logprobs (n, T); a
        row's tokens after its first END are END, its logprobs there 0."""
        n = obj.shape[0]
        END = self.V + 1
        tok = torch.full((n, 1), END, dtype=torch.long, device=obj.device)
        done = torch.zeros(n, dtype=torch.bool, device=obj.device)
        seq, lps = [], []
        for t in range(T):
            lp = torch.log_softmax(
                self.logits(self.text_states(obj, tok)[:, -1]), -1)
            best, arg = lp.max(-1)
            nxt = torch.where(done, END, arg + 1)
            seq.append(nxt)
            lps.append(torch.where(done, 0.0, best))
            done = done | (nxt == END)
            tok = torch.cat([tok, nxt[:, None]], 1)
        return torch.stack(seq, 1), torch.stack(lps, 1)

    def forward_test(self, image, h, w):
        """One image through the whole test path -> the program's outputs
        for it, as `Reference.forward_test` gives them, with
        `test_final_max_boxes` final rows (K when unset) and the logprobs
        ("logprobs")."""
        cfg = self.cfg
        K = cfg["test_max_proposals"]
        M = min(K, cfg.get("test_final_max_boxes") or K)
        feats = self.features(image, h, w)
        probs, boxes, valid = self.rpn(feats, h, w)
        keep = self.proposals(probs, boxes, valid, cfg["test_pre_nms_topk"],
                              cfg["test_rpn_nms_thresh"], K)
        n = len(keep)
        dev = image.device
        keep_t = torch.as_tensor(keep, device=dev)
        rois = torch.zeros(K, 4, device=dev)
        rois[:n] = boxes[keep_t]
        roi_scores = torch.zeros(K, device=dev)
        roi_scores[:n] = probs[keep_t]
        roi_valid = torch.arange(K, device=dev) < n
        scores, trans = self.heads(self.codes(self.roi_align(feats, rois, h,
                                                             w)))
        final = box_transform(rois, trans)
        masked = torch.where(roi_valid, scores, -1e38)
        order = torch.sort(-masked, stable=True).indices[:n]
        fk = greedy_nms(to_x1y1x2y2(final), order,
                        cfg["test_final_nms_thresh"], M)
        idx = torch.zeros(M, dtype=torch.long, device=dev)
        idx[:len(fk)] = torch.as_tensor(fk, device=dev)
        obj = self.object_features(feats, final[idx], h, w)
        tokens, lps = self.greedy(obj, cfg["seq_length"])
        return {"rois": rois, "roi_valid": roi_valid,
                "roi_scores": roi_scores, "idx": idx,
                "valid": torch.arange(M, device=dev) < len(fk),
                "boxes": final[idx], "scores": scores[idx],
                "tokens": tokens, "logprobs": lps}
