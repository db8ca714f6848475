"""densecap_tpu_torch: the PyTorch / CUDA port of densecap_tpu.

Inference and serving run on PyTorch with two hand-written CUDA kernels
(greedy NMS and RoI align, `ops/cuda/`). The JAX package `densecap_tpu`
is the reference the port is tested against; this package never imports
`jax`. Box coordinates are 1-indexed image pixels, (xc, yc, w, h) unless
a function name says otherwise.
"""
