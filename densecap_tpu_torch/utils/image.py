"""Frame loading and preprocessing for the model (twin of
densecap_tpu/utils/image.py `load_image`, `preprocess_for_model_uint8`,
`parse_buckets`, `pick_bucket` and densecap_tpu/parallel/train_step.py
`normalize_uint8_images`).

The host scales a frame so its long edge is `image_size` and places it,
BGR-ordered and still uint8, at the top left of a square canvas; the
device subtracts the VGG mean and zeroes the padding. uint8 to f32 is
exact, so the result is bit-equal to the JAX package's f32 host path
(`preprocess_for_model`). A canvas may be cropped to a smaller bucket
that still holds the frame: the model's outputs do not change.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import VGG_MEAN_BGR


def load_image(path):
    """An image file -> (H, W, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def check_frame_size(h, w, canvas_h, canvas_w):
    """Raise ValueError unless an (h, w) frame lies on its (canvas_h,
    canvas_w) canvas. RoI align on the card does not check extents (that
    would cost a host read per forward), so the host checks the sizes
    while they are still Python numbers. A side under 16 px is accepted:
    its feature extent is 0, no anchor is valid, and the model answers
    with no regions, as the JAX package does."""
    if not (0 <= h <= canvas_h and 0 <= w <= canvas_w):
        raise ValueError(
            f"a {h:g}x{w:g} frame on a {canvas_h}x{canvas_w} canvas: each "
            "side must fit the canvas")


def preprocess_for_model_uint8(rgb, image_size=720):
    """(H0, W0, 3) uint8 RGB -> (canvas (S, S, 3) uint8 BGR, h, w, scale).

    PIL resizes only when the size changes; when it does not, the frame
    is used as it is (PIL would return an identical copy). A frame whose
    short side rounds to 0 px raises PIL's ValueError, as in the JAX
    package.
    """
    H0, W0 = rgb.shape[:2]
    scale = float(image_size) / max(H0, W0)
    H, W = round(H0 * scale), round(W0 * scale)
    if (H, W) != (H0, W0):
        from PIL import Image

        rgb = np.asarray(Image.fromarray(rgb).resize((W, H), Image.BILINEAR),
                         dtype=np.uint8)
    canvas = np.zeros((image_size, image_size, 3), dtype=np.uint8)
    canvas[:H, :W] = rgb[:, :, ::-1]
    return canvas, float(H), float(W), scale


def normalize_uint8_images(images, heights, widths):
    """(B, S, S, 3) uint8 BGR canvases -> f32, VGG mean subtracted, with
    rows >= h and columns >= w zeroed after the subtraction."""
    mean = torch.tensor(VGG_MEAN_BGR, dtype=torch.float32,
                        device=images.device)
    x = images.float() - mean
    _, H, W, _ = x.shape
    dev = images.device
    row_ok = torch.arange(H, device=dev)[None, :] < heights[:, None]
    col_ok = torch.arange(W, device=dev)[None, :] < widths[:, None]
    mask = (row_ok[:, :, None] & col_ok[:, None, :])[..., None]
    return torch.where(mask, x, 0.0)


def to_model_input(canvases, heights, widths, device):
    """B uint8 canvases (a list of (H, W, 3) or one (B, H, W, 3) array)
    and their true sizes -> the model's inputs on `device`: normalized
    f32 images (B, H, W, 3), heights (B,) and widths (B,) f32. Raises
    ValueError for a size `check_frame_size` rejects."""
    ims = np.stack(canvases)
    for hi, wi in zip(heights, widths):
        check_frame_size(hi, wi, ims.shape[1], ims.shape[2])
    h = torch.tensor(heights, dtype=torch.float32, device=device)
    w = torch.tensor(widths, dtype=torch.float32, device=device)
    ims = torch.from_numpy(ims).to(device)
    return normalize_uint8_images(ims, h, w), h, w


def parse_buckets(spec, image_size):
    """'720x544,544x720' -> [(h, w), ...] sorted by area, with the
    (image_size, image_size) square always last. Dims must be multiples
    of 16 (the feature stride) and at most image_size."""
    buckets = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        h, w = (int(v) for v in part.lower().split("x"))
        if h % 16 or w % 16:
            raise ValueError(f"bucket {part}: dims must be multiples of 16")
        if h > image_size or w > image_size:
            raise ValueError(f"bucket {part} exceeds image_size {image_size}")
        buckets.add((h, w))
    buckets.add((image_size, image_size))
    return sorted(buckets, key=lambda b: b[0] * b[1])


def pick_bucket(h, w, buckets):
    """The smallest-area bucket of `parse_buckets` holding an (h, w)
    frame; the square when none does."""
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return buckets[-1]
