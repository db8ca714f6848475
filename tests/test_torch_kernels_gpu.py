"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where there is no CUDA device (a CUDA kernel has
no CPU mode). On a machine with a card and nvcc:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(`--noconftest` because the root conftest.py configures JAX.)
These are the checks of chip_smoke.py's kernel phases at smaller
shapes: NMS picks identical, RoI align within 1e-5 on unit-scale
features, and each wrapper counting exactly its own launches.
"""

import numpy as np
import pytest
import torch

from densecap_tpu_torch.models.vgg16 import feat_extent
from densecap_tpu_torch.ops import nms as nms_mod
from densecap_tpu_torch.ops import roi_align as roi_mod
from densecap_tpu_torch.ops.boxes import xcycwh_to_x1y1x2y2
from densecap_tpu_torch.ops.cuda import build

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _boxes(rng, b, n, clustered=False):
    if clustered:
        xy = rng.uniform(100, 140, (b, n, 2))
        wh = rng.uniform(40, 60, (b, n, 2))
    else:
        xy = rng.uniform(0, 720, (b, n, 2))
        wh = rng.uniform(8, 300, (b, n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("clustered", [False, True])
def test_nms_kernel_matches_plain(dev, presorted, clustered):
    rng = np.random.default_rng(int(presorted) * 2 + int(clustered))
    B, N, K = 3, 2000, 300
    boxes = xcycwh_to_x1y1x2y2(
        torch.from_numpy(_boxes(rng, B, N, clustered)).to(dev))
    scores = np.round(rng.uniform(0, 1, (B, N)), 2).astype(np.float32)
    if presorted:
        scores = -np.sort(-scores, axis=1)
    valid = torch.from_numpy(rng.uniform(0, 1, (B, N)) > 0.2).to(dev)
    args = (boxes, torch.from_numpy(scores).to(dev), 0.7, K)
    build.reset_launches()
    ki, kv = nms_mod.nms(*args, valid=valid, presorted=presorted)
    assert build.launches == {"nms": 1, "roi_align": 0}
    pi, pv = nms_mod.nms_plain(*args, valid=valid, presorted=presorted)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def test_roi_align_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(
        rng.standard_normal((3, 45, 45, 512), dtype=np.float32)).to(dev)
    img_h = torch.tensor([720.0, 540.0, 300.0], device=dev)
    img_w = torch.tensor([540.0, 720.0, 700.0], device=dev)
    fh, fw = feat_extent(img_h, img_w)
    bx = _boxes(rng, 3, 200)
    bx[..., 2:] *= 1.5
    args = (feats, torch.from_numpy(bx).to(dev), img_h, img_w, fh, fw)
    build.reset_launches()
    got = roi_mod.roi_align(*args)
    assert build.launches == {"nms": 0, "roi_align": 1}
    ref = roi_mod.roi_align_plain(*args)
    assert float((got - ref).abs().max()) <= 1e-5


def test_roi_align_kernel_is_forward_only(dev):
    feats = torch.zeros((1, 4, 4, 8), device=dev, requires_grad=True)
    one = torch.ones(1, device=dev)
    with pytest.raises(RuntimeError):
        roi_mod.roi_align_cuda(feats, torch.ones((1, 2, 4), device=dev),
                               one * 64, one * 64, one.int() * 4,
                               one.int() * 4)
