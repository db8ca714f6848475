"""Helpers shared by the port's CLIs."""

from __future__ import annotations

import torch

# What the JAX package's CLIs offer and these do not (yet).
NOT_PORTED = (
    "Flags of the JAX CLIs left out of this one: --quantize (int8 "
    "serving), --data_parallel (multi-device evaluation), --native_io / "
    "--fast_io (the native JPEG pipeline) and --roi_align / "
    "--pallas_roi_align (TPU formulations of RoI align).")


def resolve_device(name):
    """A --device flag -> torch.device. A CUDA device that is not there is
    an error, never a fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device
