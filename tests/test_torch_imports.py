"""The port never imports JAX or the JAX package: the machine with the card
has no JAX. Checked in a fresh interpreter, so this test process's own
imports do not count."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["densecap_tpu_torch", "densecap_tpu_torch.serve.server",
           "densecap_tpu_torch.serve.engine",
           "densecap_tpu_torch.models.densecap",
           "densecap_tpu_torch.ops.cuda.build",
           "densecap_tpu_torch.ops.conv_pool",
           "densecap_tpu_torch.ops.sampler", "densecap_tpu_torch.ops.losses",
           "densecap_tpu_torch.parallel.train_step",
           "densecap_tpu_torch.data.loader", "densecap_tpu_torch.cli.train",
           "densecap_tpu_torch.eval.meteor",
           "densecap_tpu_torch.eval.evaluator",
           "densecap_tpu_torch.eval.eval_split",
           "densecap_tpu_torch.cli.run_model",
           "densecap_tpu_torch.cli.extract_features",
           "densecap_tpu_torch.cli.evaluate_model",
           "densecap_tpu_torch.utils.vis",
           "densecap_tpu_torch.ops.quant",
           "densecap_tpu_torch.serve.daemon",
           "densecap_tpu_torch.native_lib",
           "chip_smoke"]


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'densecap_tpu'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout
