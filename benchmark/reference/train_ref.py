"""DenseCap's training step in plain PyTorch, batched: the reference of the
training cell. It imports nothing of the program.

It follows the reference implementation's step with trunk2 frozen (the
training default, `finetune_cnn_after -1`): the RPN on the frozen VGG
features, the sampler (positives over IoU 0.7 and the best anchor of
every ground-truth box, negatives under 0.3, inside the image; 128
positives at most and 256 RoIs in all, drawn uniformly without
replacement), 7x7 bilinear RoI sampling, fc6 / fc7 with dropout, the
objectness and box heads, the LSTM teacher-forced on the positives'
captions, the six losses (mid and end objectness, mid and end box
regression, the RPN's box decay, captioning) averaged over the batch,
weight decay added to the gradients, and Adam.

The random draws (the sampler's Gumbel top-k and redraw, then the two
dropout masks) are made from a `torch.Generator` seeded as the
program's, in the same order and shapes, so both sides draw the same
sample from the same inputs.

A step can also be replayed from a given state (the trainable leaves,
Adam's moments and count) with a given sample: the reference still
draws its own sample (so the dropout masks that follow line up), counts
the given picks that its own draw does not make, and then takes the
given ones, so that a pick flipped by rounding at an IoU threshold
moves no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .densecap_ref import ANCHORS, FIELD, VGG_MEAN_BGR, Reference

# the program's trainable zone, by the weight tree's paths
TRAINABLE = ("rpn/conv/w", "rpn/conv/b", "rpn/box/w", "rpn/box/b",
             "rpn/score/w", "rpn/score/b", "recog/fc6/w", "recog/fc6/b",
             "recog/fc7/w", "recog/fc7/b", "objectness/w", "objectness/b",
             "box_reg/w", "box_reg/b", "lm/img_enc/w", "lm/img_enc/b",
             "lm/embed", "lm/lstm/Wx", "lm/lstm/Wh", "lm/lstm/b",
             "lm/proj/w", "lm/proj/b")


def get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def put(tree, path, value):
    parts = path.split("/")
    for k in parts[:-1]:
        tree = tree[k]
    tree[parts[-1]] = value


def corners_cwh(b):
    xc, yc, w, h = b.unbind(-1)
    return xc - w / 2.0, yc - h / 2.0, xc + w / 2.0, yc + h / 2.0


def iou_cwh(a, b):
    """(B, A, 4) x (B, G, 4) xcycwh -> (B, A, G), continuous corners."""
    ax0, ay0, ax1, ay1 = (c[..., :, None] for c in corners_cwh(a))
    bx0, by0, bx1, by1 = (c[..., None, :] for c in corners_cwh(b))
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp_min(0.0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp_min(0.0)
    inter = iw * ih
    area1 = (a[..., 2] * a[..., 3])[..., :, None]
    area2 = (b[..., 2] * b[..., 3])[..., None, :]
    return inter / (area1 + area2 - inter)


def invert(anchor, target):
    xa, ya, wa, ha = anchor.unbind(-1)
    xt, yt, wt, ht = target.unbind(-1)
    wa, ha = wa.clamp_min(1e-8), ha.clamp_min(1e-8)
    wt, ht = wt.clamp_min(1e-8), ht.clamp_min(1e-8)
    return torch.stack([(xt - xa) / wa, (yt - ya) / ha, torch.log(wt / wa),
                        torch.log(ht / ha)], -1)


def draw(gen, mask, k):
    """k entries of each row of mask, uniformly without replacement (a
    Gumbel top-k); slots past a row's count repeat its draws in order."""
    B, n = mask.shape
    u = torch.rand((B, n), generator=gen, device=mask.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    g = torch.where(mask, -torch.log(-torch.log(u)), -torch.inf)
    ke = min(k, n)
    idx = torch.topk(g, ke, dim=1).indices
    if ke < k:
        idx = torch.cat([idx, idx.new_zeros((B, k - ke))], 1)
    total = mask.sum(1)
    slot = torch.arange(k, device=mask.device)[None]
    safe = total.clamp_min(1)[:, None]
    return idx.gather(1, torch.where(slot < safe, slot, slot % safe)), total


def sample(gen, boxes, gt_boxes, gt_valid, img_w, img_h, cand, cfg):
    """The sampler -> (pos_idx, pos_target, pos_valid, neg_idx, neg_valid)."""
    bs = cfg["sampler_batch_size"]
    P, M = bs // 2, bs
    B, A = boxes.shape[:2]
    ious = torch.where(gt_valid[:, None, :], iou_cwh(boxes, gt_boxes), -1.0)
    best = ious.amax(2)
    best_gt = ious.argmax(2)
    gt_best = ious.argmax(1)
    pos = best > cfg["sampler_high_thresh"]
    neg = best < cfg["sampler_low_thresh"]
    if cfg["train_remove_outbounds_boxes"]:
        xc, yc, w, h = boxes.unbind(-1)
        oob = ((xc - (w - 1) / 2.0 < 1.0) | (yc - (h - 1) / 2.0 < 1.0)
               | (xc + (w - 1) / 2.0 > img_w[:, None])
               | (yc + (h - 1) / 2.0 > img_h[:, None]))
        pos, neg = pos & ~oob, neg & ~oob
    pos, neg = pos & cand, neg & cand
    forced = torch.zeros((B, A + 1), dtype=torch.bool, device=boxes.device)
    forced.scatter_(1, torch.where(gt_valid, gt_best, A), True)
    forced = forced[:, :A]
    pos, neg = pos | forced, neg & ~forced
    any_neg = neg.any(1, keepdim=True)
    fallback = ~pos
    live = fallback & cand
    fallback = torch.where(live.any(1, keepdim=True), live, fallback)
    neg = torch.where(any_neg, neg, fallback)
    pos_idx, total_pos = draw(gen, pos, P)
    neg_idx, total_neg = draw(gen, neg, M)
    num_pos = total_pos.clamp_max(P)
    num_neg = bs - num_pos
    n = total_neg.clamp(1, M)[:, None]
    u = torch.rand(neg_idx.shape, generator=gen, device=boxes.device)
    iid = torch.minimum((u * n).long(), n - 1)
    neg_idx = torch.where((total_neg < num_neg)[:, None],
                          neg_idx.gather(1, iid), neg_idx)
    dev = boxes.device
    return (pos_idx, best_gt.gather(1, pos_idx),
            torch.arange(P, device=dev)[None] < num_pos[:, None],
            neg_idx, torch.arange(M, device=dev)[None] < num_neg[:, None])


def mismatch(given, own, G):
    """The share of the given sample's valid picks (positives as anchor
    and target, negatives as anchor) that the own draw does not make."""
    gp, gt, gv, gn, gnv = given
    op, ot, ov, on, onv = own
    gk = torch.where(gv, gp * G + gt, -1)
    ok = torch.where(ov, op * G + ot, -2)
    miss = ~(gk[..., :, None] == ok[..., None, :]).any(-1) & gv
    gn_ = torch.where(gnv, gn, -1)
    on_ = torch.where(onv, on, -2)
    miss_n = ~(gn_[..., :, None] == on_[..., None, :]).any(-1) & gnv
    n = gv.sum() + gnv.sum()
    return float((miss.sum() + miss_n.sum()) / n.clamp_min(1))


def rows(x, idx):
    """x (B, N, ...) gathered along dim 1 by idx (B, K)."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def safe_div(num, den):
    return num / den.clamp_min(1.0)


def smooth_l1(pred, target, valid):
    z = (pred - target).abs()
    elem = torch.where(z < 1.0, 0.5 * z * z, z - 0.5) * valid[..., None]
    return safe_div(elem.sum((-2, -1)), valid.float().sum(-1) * pred.shape[-1])


def masked_pair(trans, target):
    ok = (target.abs().amax(-1, keepdim=True) <= 10.0).detach()
    return torch.where(ok, trans, 0.0), torch.where(ok, target, 0.0)


def ce(scores, label, valid):
    nll = -torch.log_softmax(scores, -1)[..., label]
    return safe_div((nll * valid).sum(-1), valid.float().sum(-1))


class TrainReference(Reference):
    """The step on a weight tree whose trainable leaves take gradients."""

    def __init__(self, tree, cfg, precision="f32"):
        super().__init__(tree, cfg, precision)
        for path in TRAINABLE:
            put(tree, path, get(tree, path).detach().clone()
                .requires_grad_(True))
        self.params = {p: get(tree, p) for p in TRAINABLE}
        self.m = {p: torch.zeros_like(v) for p, v in self.params.items()}
        self.v = {p: torch.zeros_like(v) for p, v in self.params.items()}
        self.t = 0

    def load_state(self, params, m, v, t):
        """Trainable leaves, Adam's moments ({path: tensor}, the tree's
        layout) and Adam's count, in place of the current ones."""
        with torch.no_grad():
            for path in TRAINABLE:
                self.params[path].copy_(params[path])
                self.m[path].copy_(m[path])
                self.v[path].copy_(v[path])
        self.t = int(t)

    def losses(self, batch, gen, given=None):
        """Per-image total losses (B,) of one batch of device tensors.
        `given`: a sample (pos_idx, pos_target, pos_valid, neg_idx,
        neg_valid) to take in place of the reference's own draw; the
        share of its valid picks that the own draw lacks is left in
        `self.sample_mismatch`. The sample taken is left in
        `self.sample`."""
        cfg = self.cfg
        mean = torch.tensor(VGG_MEAN_BGR, device=batch["image"].device)
        img = batch["image"].float() - mean
        hs, ws = batch["height"].float(), batch["width"].float()
        B, H, W, _ = img.shape
        rr = torch.arange(H, device=img.device)[None, :, None]
        cc = torch.arange(W, device=img.device)[None, None, :]
        inside = (rr < hs[:, None, None]) & (cc < ws[:, None, None])
        img = torch.where(inside[..., None], img, 0.0)
        with torch.no_grad():
            feats = torch.stack([self.features(img[b], float(hs[b]),
                                               float(ws[b]))
                                 for b in range(B)])
        r = self.p["rpn"]
        k = len(ANCHORS)
        Hf, Wf = feats.shape[2:]
        hid = torch.relu(self.conv(feats, r["conv"]["w"], r["conv"]["b"], 1))
        trans = self.conv(hid, r["box"]["w"], r["box"]["b"], 0)
        scores = self.conv(hid, r["score"]["w"], r["score"]["b"], 0)
        trans = trans.reshape(B, k, 4, Hf, Wf).permute(0, 1, 3, 4, 2
                                                       ).reshape(B, -1, 4)
        scores = scores.reshape(B, k, 2, Hf, Wf).permute(0, 1, 3, 4, 2
                                                         ).reshape(B, -1, 2)
        dev = feats.device
        x0, y0, sx, sy = FIELD
        xc = x0 + sx * torch.arange(Wf, device=dev, dtype=torch.float32)
        yc = y0 + sy * torch.arange(Hf, device=dev, dtype=torch.float32)
        sizes = torch.tensor(ANCHORS, dtype=torch.float32, device=dev)
        anchors = torch.stack([
            xc[None, None, :].expand(k, Hf, Wf),
            yc[None, :, None].expand(k, Hf, Wf),
            sizes[:, 0, None, None].expand(k, Hf, Wf),
            sizes[:, 1, None, None].expand(k, Hf, Wf)], -1).reshape(-1, 4)
        xa, ya, wa, ha = anchors.unbind(-1)
        tx, ty, tw, th = trans.unbind(-1)
        boxes = torch.stack([tx * wa + xa, ty * ha + ya,
                             wa * torch.exp(tw.clamp(-20, 20)),
                             ha * torch.exp(th.clamp(-20, 20))], -1)
        # four floor-halvings of the extent are one floor(/16)
        fh = torch.div(hs, 16, rounding_mode="floor")
        fw = torch.div(ws, 16, rounding_mode="floor")
        rows_ok = torch.arange(Hf, device=dev)[None, :, None] < fh[:, None,
                                                                  None]
        cols_ok = torch.arange(Wf, device=dev)[None, None, :] < fw[:, None,
                                                                  None]
        cand = (rows_ok & cols_ok).reshape(B, -1).repeat(1, k)
        decay = 0.5 * cfg["box_reg_decay"] * (trans * trans * cand[..., None]
                                              ).sum((1, 2))
        dead = torch.tensor([-1e6, -1e6, 1.0, 1.0], device=dev)
        eff = torch.where(cand[..., None], boxes.detach(), dead)
        own = sample(gen, eff, batch["gt_boxes"].float(), batch["gt_valid"],
                     ws, hs, cand, cfg)
        if given is not None and any(g.shape != o.shape
                                     for g, o in zip(given, own)):
            self.sample_mismatch = 1.0  # not a sample of this batch
        elif given is not None:
            self.sample_mismatch = mismatch(given, own,
                                            batch["gt_boxes"].shape[1])
            own = tuple(g.to(o.dtype) for g, o in zip(given, own))
        self.sample = own
        pos_idx, pos_tgt, pos_valid, neg_idx, neg_valid = own
        P = pos_idx.shape[1]
        pos_boxes = rows(boxes, pos_idx)
        pos_anchors = anchors[pos_idx]
        pos_trans = rows(trans, pos_idx)
        pos_scores = rows(scores, pos_idx)
        neg_boxes = rows(boxes, neg_idx)
        neg_scores = rows(scores, neg_idx)
        tgt_boxes = rows(batch["gt_boxes"].float(), pos_tgt)
        labels = rows(batch["gt_labels"].long(), pos_tgt)
        roi_boxes = torch.cat([pos_boxes, neg_boxes], 1)
        R = roi_boxes.shape[1]
        roi_feats = torch.stack([
            self.roi_align(feats[b], roi_boxes[b], float(hs[b]), float(ws[b]))
            for b in range(B)])
        mid_obj = cfg["mid_objectness_weight"] * (
            ce(pos_scores, 0, pos_valid) + ce(neg_scores, 1, neg_valid))
        pt, tt = masked_pair(pos_trans, invert(pos_anchors, tgt_boxes))
        mid_box = cfg["mid_box_reg_weight"] * smooth_l1(pt, tt, pos_valid)

        keep = 1.0 - cfg["drop_prob"]
        x = roi_feats.reshape(B * R, -1)
        rec = self.p["recog"]
        for name in ("fc6", "fc7"):
            x = torch.relu(self.mm(x, rec[name]["w"], rec[name]["b"]))
            m = torch.rand(x.shape, generator=gen, device=dev) < keep
            x = torch.where(m, x / keep, 0.0)
        codes = x
        o, bx = self.p["objectness"], self.p["box_reg"]
        obj = self.mm(codes, o["w"], o["b"]).reshape(B, R, 1)
        roi_valid = torch.cat([pos_valid, neg_valid], 1)
        y = torch.cat([pos_valid.float(),
                       torch.zeros_like(neg_valid.float())], 1)[..., None]
        elem = (F.softplus(-obj) + (1.0 - y) * obj) * roi_valid[..., None]
        end_obj = cfg["end_objectness_weight"] * safe_div(
            elem.sum((1, 2)), roi_valid.float().sum(1))
        pos_codes = codes.reshape(B, R, -1)[:, :P].reshape(B * P, -1)
        ftrans = self.mm(pos_codes, bx["w"], bx["b"]).reshape(B, P, 4)
        pb, tb = masked_pair(ftrans, invert(pos_boxes, tgt_boxes))
        end_box = cfg["end_box_reg_weight"] * smooth_l1(pb, tb, pos_valid)
        cap = cfg["captioning_weight"] * self.caption_loss(
            pos_codes, labels.reshape(B * P, -1), pos_valid)
        return mid_obj + mid_box + decay + end_obj + end_box + cap

    def caption_loss(self, codes, labels, valid):
        """Teacher forcing over T + 2 steps and the summed cross entropy of
        the non-null targets, over the valid rows (per image)."""
        N, T = labels.shape
        B = valid.shape[0]
        V = self.V
        seq = torch.cat([labels.new_full((N, 1), V + 1), labels], 1)
        seq = torch.where(seq == 0, V + 2, seq)
        xs = [self.encode(codes)] + [self.embed(seq[:, t])
                                     for t in range(T + 1)]
        z = torch.zeros(N, self.p["lm"]["lstm"]["Wh"].shape[0],
                        device=codes.device)
        h, c = z, z
        hs = []
        for x in xs:
            h, c = self.lstm_step(h, c, x)
            hs.append(h)
        logits = self.logits(torch.stack(hs, 1).reshape(N * (T + 2), -1))
        logp = torch.log_softmax(logits, -1).reshape(N, T + 2, -1)
        y = torch.cat([labels, labels.new_zeros((N, 1))], 1)
        first0 = (y == 0).int().argmax(1, keepdim=True)
        y = y.scatter(1, first0, torch.full_like(first0, V + 1))
        target = torch.cat([labels.new_zeros((N, 1)), y], 1)
        nll = -logp.gather(2, (target - 1).clamp_min(0)[..., None])[..., 0]
        mask = (target > 0).reshape(B, -1, T + 2) & valid[..., None]
        return safe_div((nll.reshape(B, -1, T + 2) * mask).sum((1, 2)),
                        valid.float().sum(1))

    def step(self, batch, gen, given=None):
        """One update; -> (batch-mean loss, {leaf: gradient as Adam gets
        it})."""
        cfg = self.cfg
        for p in self.params.values():
            p.grad = None
        loss = self.losses(batch, gen, given).sum() / batch["image"].shape[0]
        loss.backward()
        b1, b2 = cfg["optim_beta1"], cfg["optim_beta2"]
        lr, eps, wd = cfg["learning_rate"], cfg["optim_epsilon"], \
            cfg["weight_decay"]
        self.t += 1
        grads = {}
        with torch.no_grad():
            for name, p in self.params.items():
                g = (p.grad if p.grad is not None else torch.zeros_like(p))
                g = g + wd * p
                grads[name] = g
                self.m[name].mul_(b1).add_(g, alpha=1 - b1)
                self.v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
                denom = (self.v[name].sqrt() / bc2 ** 0.5).add_(eps)
                p.addcdiv_(self.m[name], denom, value=-lr / bc1)
        return float(loss.detach()), grads
