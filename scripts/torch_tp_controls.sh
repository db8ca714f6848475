#!/bin/bash
# The readings behind chip_smoke.TP_BF16_LARGE_G: chip_smoke's
# [tensor parallel] run in bf16 (tp_run: two gloo ranks on cuda:0, M = 2,
# flagship width, each step against one unsharded process from the same
# state) on this tree and on two copies of it, each broken by one edit:
#
#   noreduce  copy_to_model's backward skips its all-reduce (a fault: each
#             rank keeps only its part of the input gradient);
#   nof32     Linear copies its input into the group without the f32 cast
#             (a rounding variant: the partial input gradients are rounded
#             to bf16 and summed in bf16).
#
# Run from the repo root on one GPU:  bash scripts/torch_tp_controls.sh
# Prints, per variant, each step's differences (the largest where |g| is
# large is the bound's reading). The copies live in a temporary directory
# that is removed at the end.
set -u
root=$(pwd)
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for v in sound noreduce nof32; do
  d=$root
  if [ "$v" != sound ]; then
    d=$tmp/$v
    mkdir -p "$d"
    (cd "$root" && tar --exclude=./.git --exclude=./build --exclude=./chiprun_out -cf - .) \
      | tar -xf - -C "$d"
  fi
  case $v in
    noreduce)
      f=$d/densecap_tpu_torch/parallel/tensor_parallel.py
      sed -i 's/^        dist.all_reduce(g, group=ctx.group)$/        pass/' "$f"
      ! grep -q "dist.all_reduce(g, group=ctx.group)" "$f";;
    nof32)
      f=$d/densecap_tpu_torch/models/vgg16.py
      sed -i 's/copy_to_model(x.float(), self.shard)/copy_to_model(x, self.shard)/' "$f"
      grep -q "copy_to_model(x, self.shard)" "$f";;
  esac || { echo "$v: the edit did not apply"; exit 1; }
  echo "== $v"
  (cd "$d" && python - <<'PY'
import torch

import chip_smoke as c
from densecap_tpu_torch.utils.checkpoint import init_params

c.phase_device()
c.build.load()
saved, errs, err, floor, wall = c.tp_run(
    torch.device("cuda", 0), init_params(c.FLAGSHIP, seed=0), "bfloat16")
print("steps (losses rel err, params max diff, that where |g| is large):",
      errs)
PY
  ) 2>&1 | grep "tensor parallel\] bfloat16 step\|^steps\|Error"
done
