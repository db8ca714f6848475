"""Evaluate a model on a dataset split (twin of
densecap_tpu/eval/eval_split.py, after the reference's eval_utils.lua):
test-time detections scored by the mAP evaluator, and optionally the
training losses per image; the batched test pass optionally data
parallel over replicas of the model (`parallel.mesh.Replicas`)."""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Replicas
from ..utils.image import pick_bucket, to_model_input
from ..utils.text import decode_sequence
from .evaluator import DenseCaptioningEvaluator


def eval_split(model, loader, split=1, max_images=-1, id="",
               loss_generator=None, verbose=True, beam_size=0,
               compute_losses=True, batch_size=1, canvas_buckets=None,
               devices=None):
    """Evaluate `model` (a `DenseCap`) on `split` of `loader` (the port's
    `DenseCapLoader`, or anything with its split API and uint8 canvases),
    on the model's device.

    Images run through `forward_test_batch` `batch_size` at a time; a
    split that does not divide runs its tail as a smaller batch. With
    `compute_losses` (only at `batch_size` 1, as in the JAX package) each
    image also runs `forward_train`, with dropout and the sampler drawn
    from `loss_generator` (a `torch.Generator` on the model's device,
    seeded 0 when not given), and the losses are averaged.
    `canvas_buckets` (from `utils.image.parse_buckets`): each batch is
    cropped to the smallest bucket holding all of its images, which
    leaves the outputs as they are. `beam_size` > 0 decodes by beam
    search. `devices`: with more than one (and `batch_size` > 1) each
    batch's test pass is split into contiguous shards, one per device,
    each run on its own replica of `model` (`parallel.mesh.Replicas`,
    its own thread and stream); a shard may be smaller than the others,
    and nothing is padded. The loss pass and batch 1 stay on `model`, as
    the JAX package keeps them off its mesh.

    Returns {"loss_results": {name: mean}, "ap_results": evaluator dict}.
    """
    if batch_size > 1:
        compute_losses = False
    cfg = model.cfg
    dev = model.obj_w.device
    split_n = loader.split_size(split)
    n_images = split_n if max_images <= 0 else min(max_images, split_n)
    loader.reset_iterator(split)
    evaluator = DenseCaptioningEvaluator(id=id)
    idx_to_token = loader.idx_to_token()
    if compute_losses and loss_generator is None:
        loss_generator = torch.Generator(device=dev).manual_seed(0)

    replicas = (Replicas(model, devices)
                if devices is not None and len(devices) > 1 and batch_size > 1
                else None)

    def fwd(m, x, h, w):
        return m.forward_test_batch(x, h, w, use_beam=beam_size)

    all_losses = []
    done = 0
    try:
        while done < n_images:
            exs = [loader.get_example(split=split, iterate=True)
                   for _ in range(min(batch_size, n_images - done))]
            ims = np.stack([e["image"] for e in exs])
            if canvas_buckets:
                bh = max(pick_bucket(e["height"], e["width"],
                                     canvas_buckets)[0] for e in exs)
                bw = max(pick_bucket(e["height"], e["width"],
                                     canvas_buckets)[1] for e in exs)
                # cover (bh, bw) with a listed bucket, so shapes stay few
                bh, bw = pick_bucket(bh, bw, canvas_buckets)
                ims = ims[:, :bh, :bw]
            hs = [float(e["height"]) for e in exs]
            ws = [float(e["width"]) for e in exs]

            if replicas is None:
                x, h, w = to_model_input(ims, hs, ws, dev)
            if compute_losses:  # batch 1: never on replicas
                gt = {k: torch.from_numpy(np.stack([e[k] for e in exs])
                                          ).to(dev)
                      for k in ("gt_boxes", "gt_labels", "gt_valid")}
                with torch.no_grad():
                    losses = model.forward_train(
                        x, h, w, gt["gt_boxes"], gt["gt_labels"].long(),
                        gt["gt_valid"], generator=loss_generator)
                all_losses.append({k: float(v.mean())
                                   for k, v in losses.items()})

            outs = ([fwd(model, x, h, w)] if replicas is None
                    else replicas.run(ims, hs, ws, fn=fwd))
            valid, boxes, scores, captions = (
                np.concatenate([getattr(o, k).cpu().numpy() for o in outs])
                for k in ("valid", "boxes", "scores", "captions"))
            for i, ex in enumerate(exs):
                v = valid[i]
                gv = np.asarray(ex["gt_valid"])
                evaluator.add_result(
                    scores[i][v], boxes[i][v],
                    decode_sequence(captions[i][v], idx_to_token,
                                    cfg.vocab_size),
                    np.asarray(ex["gt_boxes"])[gv],
                    decode_sequence(np.asarray(ex["gt_labels"])[gv],
                                    idx_to_token, cfg.vocab_size))
                if verbose:
                    print(f"Processed image {ex['filename']} ({done + i + 1}"
                          f"/{n_images}) of split {split}, detected "
                          f"{int(v.sum())} regions")
            done += len(exs)
    finally:
        if replicas is not None:
            replicas.close()

    loss_results = ({k: float(np.mean([d[k] for d in all_losses]))
                     for k in all_losses[0]} if all_losses else {})
    ap_results = evaluator.evaluate()
    if verbose:
        print(f"mAP: {100 * ap_results['map']:.4f} "
              f"(caption scorer: {ap_results['score_method']})")
    return {"loss_results": loss_results, "ap_results": ap_results}
