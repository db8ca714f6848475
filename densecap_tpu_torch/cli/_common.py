"""Helpers shared by the port's CLIs."""

from __future__ import annotations

import torch

# What the JAX package's CLIs offer and these do not (yet).
NOT_PORTED = (
    "Flags of the JAX CLIs left out of this one: --roi_align / "
    "--pallas_roi_align (TPU formulations of RoI align) and --uint8_pipe 0 "
    "(the port always feeds uint8 canvases).")


def resolve_device(name):
    """A --device flag -> torch.device. A CUDA device that is not there is
    an error, never a fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device


def resolve_data_parallel(n, device):
    """A --data_parallel flag -> the replicas' devices
    (`parallel.mesh.data_devices`), or None for 1. More GPUs than are
    visible is an error, never fewer replicas."""
    if n <= 1:
        return None
    from ..parallel.mesh import data_devices

    try:
        return data_devices(n, device)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def maybe_quantize(params, mode: str):
    """Apply the --quantize flag to a loaded numpy params tree.

    "" / "none": the tree as it is. "int8": W8A8-quantize the recognition
    fc6 and fc7 (`ops.quant.quantize_for_inference`); the vocab projection
    stays full precision, as the JAX CLIs leave it. Inference only: the
    train CLI never calls this.
    """
    if mode in ("", "none"):
        return params
    if mode == "int8":
        from ..ops.quant import quantize_for_inference

        return quantize_for_inference(params)
    raise SystemExit(f"--quantize: unknown mode {mode!r} "
                     "(expected none|int8)")


def add_quantize_flag(parser):
    parser.add_argument(
        "--quantize", default="", choices=["", "none", "int8"],
        help="int8: W8A8-quantize the recognition fc6/fc7 (int8 weights "
             "per output channel, int8 activations per row, int32 "
             "products); the box, objectness and caption branches stay "
             "full precision. Default off.")
