"""Draw boxes and captions onto an image with PIL (twin of
densecap_tpu/utils/vis.py, after the reference's vis_utils.lua and its
WAD colour palette)."""

from __future__ import annotations

import numpy as np

# WAD palette, RGB 0..255
WAD_COLORS = [
    (173, 35, 35), (42, 75, 215), (87, 87, 87), (29, 105, 20),
    (129, 74, 25), (129, 38, 192), (160, 160, 160), (129, 197, 122),
    (157, 175, 255), (41, 208, 208), (255, 146, 51), (255, 238, 51),
    (233, 222, 187), (255, 205, 243),
]


def densecap_draw(rgb, boxes_xywh, captions, box_width=2, text_size=12):
    """(H, W, 3) uint8 RGB with boxes (N, 4) xywh (1-indexed) and their
    captions drawn in -> a new (H, W, 3) uint8 array. Each caption sits
    on a filled bar above its box when PIL has a default font."""
    from PIL import Image, ImageDraw, ImageFont

    im = Image.fromarray(np.asarray(rgb, dtype=np.uint8))
    draw = ImageDraw.Draw(im)
    try:
        font = ImageFont.load_default(size=text_size)
    except (OSError, TypeError):  # no FreeType, or a PIL without size=
        font = None
    boxes = np.asarray(boxes_xywh, dtype=np.float64)
    for i, (box, caption) in enumerate(zip(boxes, captions)):
        color = WAD_COLORS[i % len(WAD_COLORS)]
        x, y, w, h = box
        x0, y0 = x - 1, y - 1  # 1-indexed -> pixel coordinates
        draw.rectangle([x0, y0, x0 + w - 1, y0 + h - 1], outline=color,
                       width=box_width)
        if caption and font is not None:
            ty = max(y0 - text_size - 2, 0)
            tw = draw.textlength(caption, font=font)
            draw.rectangle([x0, ty, x0 + tw + 4, ty + text_size + 2],
                           fill=color)
            draw.text((x0 + 2, ty), caption, fill=(255, 255, 255), font=font)
    return np.asarray(im)
