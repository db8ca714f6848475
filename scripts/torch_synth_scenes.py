"""Synthetic scenes of the port's learning checks, in numpy alone.

Solid coloured rectangles on a noisy grey background, as BGR canvases
with the mean subtracted (the reference pipeline's input), their boxes
(xcycwh) and captions. The draws are those of the JAX package's scripts,
in the same order, so the arrays are byte-equal to theirs:

  * `box_scenes`: 2-3 boxes an image, captioned "<color> box"
    (scripts/overfit_sanity.py `make_dataset`, scripts/generalize_check.py
    `make_scenes`);
  * `caption_scenes`: 2-4 boxes on 540 px of a 720x544 canvas, captioned
    by a template of 2-9 words chosen from the box's colour and size
    (scripts/trained_weights_bench.py `make_dataset`).

Imported by the `scripts/torch_*` learning checks and by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np

COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 40), "blue": (40, 60, 200),
    "yellow": (220, 210, 40),
}
MEAN_BGR = (103.9, 116.8, 123.7)
G = 4  # gt slots per image

# box_scenes: words 1..5
BOX_VOCAB = ["box"] + list(COLORS)
BOX_TOK = {w: i + 1 for i, w in enumerate(BOX_VOCAB)}
BOX_SEQ = 3

# caption_scenes: words 1..16, points in a vocabulary of any size
CAPTION_WORDS = ["a", "the", "on", "box", "background", "small", "large",
                 "sits", "near", "edge", "gray", "bright"] + list(COLORS)
CAPTION_TOK = {w: i + 1 for i, w in enumerate(CAPTION_WORDS)}
CAPTION_SEQ = 15
CANVAS_H, CANVAS_W = 720, 544
CONTENT_W = 540.0
TEMPLATES = [
    lambda c, s: [c, "box"],
    lambda c, s: ["a", s, c, "box"],
    lambda c, s: ["a", c, "box", "on", "the", "background"],
    lambda c, s: ["a", s, c, "box", "on", "the", "gray", "background"],
    lambda c, s: ["a", "bright", s, c, "box", "sits", "near", "the",
                  "edge"],
]


def caption_for(color, size):
    """The template of (color, size), by a hash that is the same in
    every process (Python's str hash is salted)."""
    return TEMPLATES[sum(map(ord, color + size)) % len(TEMPLATES)](color,
                                                                  size)


def _to_input(img):
    return img[:, :, ::-1] - np.array(MEAN_BGR)


def box_scenes(n, seed, size=192, box_range=(30, 80)):
    """n size x size scenes of 2-3 boxes with sides in [lo, hi):
    (images (n, S, S, 3) f32, gt_boxes (n, G, 4) f32, gt_labels (n, G, 3)
    int32, gt_valid (n, G) bool, texts: n lists of "<color> box")."""
    S, (lo, hi) = size, box_range
    rng = np.random.RandomState(seed)
    images = np.zeros((n, S, S, 3), np.float32)
    gt_boxes = np.zeros((n, G, 4), np.float32)
    gt_labels = np.zeros((n, G, BOX_SEQ), np.int32)
    gt_valid = np.zeros((n, G), bool)
    texts = []
    for i in range(n):
        img = rng.uniform(90, 130, (S, S, 3)).astype(np.float32)
        names = []
        for b in range(rng.randint(2, 4)):
            color = list(COLORS)[rng.randint(len(COLORS))]
            w, h = rng.randint(lo, hi, 2)
            x = rng.randint(1, S - w - 1)
            y = rng.randint(1, S - h - 1)
            img[y:y + h, x:x + w] = COLORS[color]
            gt_boxes[i, b] = [x + w / 2.0, y + h / 2.0, w, h]
            gt_labels[i, b, :2] = [BOX_TOK[color], BOX_TOK["box"]]
            gt_valid[i, b] = True
            names.append(f"{color} box")
        images[i] = _to_input(img)
        texts.append(names)
    return images, gt_boxes, gt_labels, gt_valid, texts


def overfit_scenes(full=False, seed=0):
    """The overfit check's 16 scenes: 192 px with sides 30-80, or with
    `full` 720 px with sides 60-300 (the sizes of the anchors)."""
    if full:
        return box_scenes(16, seed, 720, (60, 300))
    return box_scenes(16, seed)


def caption_scenes(seed=0, n=16):
    """n 720x544 canvases with 2-4 boxes in the first 540 columns, sides
    60-300, captioned by `caption_for`: (images (n, 720, 544, 3) f32,
    gt_boxes (n, G, 4) f32, gt_labels (n, G, 15) int32, gt_valid (n, G)
    bool)."""
    S, W = CANVAS_H, CANVAS_W
    rng = np.random.RandomState(seed)
    images = np.zeros((n, S, W, 3), np.float32)
    gt_boxes = np.zeros((n, G, 4), np.float32)
    gt_labels = np.zeros((n, G, CAPTION_SEQ), np.int32)
    gt_valid = np.zeros((n, G), bool)
    for i in range(n):
        img = rng.uniform(90, 130, (S, W, 3)).astype(np.float32)
        for b in range(rng.randint(2, G + 1)):
            color = list(COLORS)[rng.randint(len(COLORS))]
            w, h = rng.randint(60, 300, 2)
            x = rng.randint(1, int(CONTENT_W) - w - 1)
            y = rng.randint(1, S - h - 1)
            img[y:y + h, x:x + w] = COLORS[color]
            words = caption_for(color, "small" if w * h < 160 * 160
                                else "large")
            gt_boxes[i, b] = [x + w / 2.0, y + h / 2.0, w, h]
            gt_labels[i, b, :len(words)] = [CAPTION_TOK[t] for t in words]
            gt_valid[i, b] = True
        images[i] = _to_input(img)
    return images, gt_boxes, gt_labels, gt_valid
