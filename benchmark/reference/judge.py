"""Judging served detections and captions against the reference.

Random weights make bf16 rounding change which near-tied proposal NMS
keeps and which near-tied word the decoder picks, so the outputs are not
compared with the reference's own outputs. Each decision of the program
is judged instead by how far the reference, in f32, ranks it below the
best choice the program had at that point (the served-token rule for
served models, applied to every stage), and each guarantee of greedy NMS
is checked exactly:

  * rpn_score_err (with the program's proposals): the widest gap between
    the objectness probability the RPN gave a kept proposal and the
    reference's for the same anchor.
  * rpn_bad_picks: kept proposals that are no candidate's box, or that an
    earlier kept proposal overlaps at IoU over 0.7 (K1's guarantee).
  * rpn_gap: for the i-th kept proposal, the reference's best probability
    among the candidates no earlier one suppresses, less its own.
  * final_gap, final_bad_picks: the same for the final NMS (K1 at 0.3)
    over the program's proposals, with the reference's objectness logits.
  * score_err: the widest gap between a served objectness logit and the
    reference's for the same box.
  * token_gap: the widest gap by which a served token's logit lies below
    the reference's best at that step, teacher-forced on the served
    tokens up to and including the first END.

The candidate boxes are the RPN's clipped proposals; the trunk, K2,
fc6 / fc7, the heads and the LSTM are judged through the scores and
tokens, which the reference computes from its own features at the
program's boxes. Which of these a cell compares, and their limits, are
in its workload file.
"""

from __future__ import annotations

import torch

from .densecap_ref import box_transform, iou_pascal, to_x1y1x2y2

BOX_TOL_PX = 0.02
MISS = 1.0e6


def match(q, cand, probs, valid, tol=BOX_TOL_PX, chunk=256):
    """Each box of q (m, 4) -> the valid candidate within `tol` px (every
    coordinate) of the highest probability: (index (m,), found (m,))."""
    idx, found = [], []
    for s in range(0, q.shape[0], chunk):
        d = (q[s:s + chunk, None, :] - cand[None]).abs().amax(-1)
        ok = (d <= tol) & valid[None]
        score = torch.where(ok, probs[None], -1.0)
        idx.append(score.argmax(1))
        found.append(ok.any(1))
    if not idx:
        z = torch.zeros(0, dtype=torch.long, device=q.device)
        return z, z.bool()
    return torch.cat(idx), torch.cat(found)


def nms_gaps(cand_x, cand_score, cand_ok, picks_x, pick_idx, pick_ok,
             thresh, slots, miss_floor):
    """Greedy-NMS gaps of a sequence of picks (see the module docstring).
    cand_x (A, 4) x1y1x2y2 with scores (A,) and availability (A,);
    picks_x (n, 4) the program's boxes, pick_idx (n,) their candidate
    index, pick_ok (n,) whether they matched one. -> ((n + 1,) gaps, the
    last for the slot after the picks (0 when all `slots` are filled or
    nothing remains), and the number of bad picks: no candidate's box, or
    suppressed by an earlier pick)."""
    n = picks_x.shape[0]
    if n:
        S = iou_pascal(cand_x, picks_x) > thresh              # (A, n)
        E = S.to(torch.uint8).cummax(1).values.bool()
        before = torch.cat([torch.zeros_like(E[:, :1]), E[:, :-1]], 1)
        avail = cand_ok[:, None] & ~before
        best = torch.where(avail, cand_score[:, None], -torch.inf).amax(0)
        own = cand_score[pick_idx]
        free = avail[pick_idx, torch.arange(n, device=avail.device)]
        good = pick_ok & free
        gaps = torch.where(good, best - own,
                           torch.full_like(best, miss_floor))
        bad = int((~good).sum())
        left = cand_ok & ~E[:, -1]
    else:
        gaps, bad = cand_score.new_zeros(0), 0
        left = cand_ok
    tail = cand_score.new_zeros(1)
    if n < slots and bool(left.any()):
        tail[0] = cand_score[left].max() - cand_score[cand_ok].min()
    return torch.cat([gaps, tail]), bad


def token_gaps(ref, codes, tokens):
    """Per served row, the widest logit gap of its tokens; and over all
    judged positions, the share whose token is not the reference's best
    and the mean gap."""
    if tokens.shape[0] == 0:
        return codes.new_zeros(0), 0.0, 0.0
    END = ref.V + 1
    lg = ref.teacher_logits(codes, tokens)                    # (N, T, V+1)
    tok = tokens.long()
    own = lg.gather(2, (tok - 1).clamp(0, lg.shape[2] - 1)[..., None])[..., 0]
    gap = lg.amax(2) - own
    is_end = tok == END
    first = torch.where(is_end.any(1), is_end.int().argmax(1),
                        torch.full_like(tok[:, 0], tok.shape[1] - 1))
    upto = torch.arange(tok.shape[1], device=tok.device)[None] <= first[:,
                                                                      None]
    bad = (tok < 1) | (tok > END)
    gap = torch.where(bad, torch.full_like(gap, MISS), gap)
    n = upto.sum().clamp_min(1)
    off = ((gap > 0) & upto).sum() / n
    mean = torch.where(upto, gap, 0.0).sum() / n
    return torch.where(upto, gap, 0.0).amax(1), float(off), float(mean)


def codes_at(ref, feats, boxes, h, w, chunk=512):
    out = []
    for s in range(0, boxes.shape[0], chunk):
        out.append(ref.codes(ref.roi_align(feats, boxes[s:s + chunk], h, w)))
    return torch.cat(out) if out else feats.new_zeros(0, ref.cfg["fc_dim"])


@torch.no_grad()
def judge(ref, image, h, w, served):
    """One image. served: boxes (n, 4) canvas xcycwh in served order,
    scores (n,), tokens (n, T), the program's proposals rois (K, 4) with
    roi_valid (K,) and roi_scores (K,), and idx (n,) into them. ->
    {number: value}."""
    cfg = ref.cfg
    feats = ref.features(image, h, w)
    probs, pboxes, pvalid = ref.rpn(feats, h, w)
    boxes, scores, tokens = served["boxes"], served["scores"], served["tokens"]
    out = {}
    rois = served["rois"][served["roi_valid"]]
    a, found = match(rois, pboxes, probs, pvalid)
    masked = torch.where(pvalid, probs, -torch.inf)
    order = torch.sort(-masked, stable=True).indices
    top = torch.zeros_like(pvalid)
    top[order[:min(cfg["test_pre_nms_topk"], int(pvalid.sum()))]] = True
    top[a[found]] = True
    rpn, bad = nms_gaps(to_x1y1x2y2(pboxes), probs, pvalid & top,
                        to_x1y1x2y2(rois), a, found,
                        cfg["test_rpn_nms_thresh"],
                        cfg["test_max_proposals"], 1.0)
    out["rpn_gap"] = float(rpn.max())
    out["rpn_bad_picks"] = float(bad)
    err = (served["roi_scores"][served["roi_valid"]] - probs[a]).abs()
    out["rpn_score_err"] = float(torch.where(found, err, 1.0).max())
    out["rpn_score_rms"] = float(err[found].square().mean().sqrt())
    codes = codes_at(ref, feats, rois, h, w)
    s_ref, trans = ref.heads(codes)
    fb = box_transform(rois, trans)
    idx = served["idx"].long()
    tol = BOX_TOL_PX + 1e-3 * fb[idx, 2:].abs().amax(-1)
    same = ((boxes - fb[idx]).abs().amax(-1) <= tol)
    n_ok = torch.ones(rois.shape[0], dtype=torch.bool,
                      device=rois.device)
    fin, bad = nms_gaps(to_x1y1x2y2(fb), s_ref, n_ok,
                        to_x1y1x2y2(boxes), idx, same,
                        cfg["test_final_nms_thresh"],
                        cfg["test_max_proposals"], MISS)
    out["final_gap"] = float(fin.max())
    out["final_bad_picks"] = float(bad)
    s_served, codes_s = s_ref[idx], codes[idx]
    err = (scores - s_served).abs()
    out["score_err"] = float(err.max()) if err.numel() else 0.0
    out["score_rms"] = (float(err.square().mean().sqrt()) if err.numel()
                        else 0.0)
    tg, off, mean = token_gaps(ref, codes_s, tokens)
    out["token_gap"] = float(tg.max()) if tg.numel() else 0.0
    out["token_off_share"], out["token_gap_mean"] = off, mean
    out["rows"] = int(boxes.shape[0])
    return out


def worst(readings):
    """The widest of each number over several images' readings."""
    keys = {k for r in readings for k in r if k != "rows"}
    out = {k: max(r[k] for r in readings if k in r) for k in sorted(keys)}
    out["rows"] = sum(r.get("rows", 0) for r in readings)
    return out
