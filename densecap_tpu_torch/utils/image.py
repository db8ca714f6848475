"""Frame preprocessing for the model (twin of densecap_tpu/utils/image.py
`preprocess_for_model_uint8` and densecap_tpu/parallel/train_step.py
`normalize_uint8_images`).

The host scales a frame so its long edge is `image_size` and places it,
BGR-ordered and still uint8, at the top left of a square canvas; the
device subtracts the VGG mean and zeroes the padding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import VGG_MEAN_BGR


def preprocess_for_model_uint8(rgb, image_size=720):
    """(H0, W0, 3) uint8 RGB -> (canvas (S, S, 3) uint8 BGR, h, w, scale).

    PIL resizes only when the size changes; when it does not, the frame
    is used as it is (PIL would return an identical copy).
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
