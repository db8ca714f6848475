"""The port never imports JAX, optax, orbax or the JAX package: the machine
with the card has none of them. Checked in a fresh interpreter, so this
test process's own imports do not count. Also the help epilog that names
the JAX CLIs' flags the port leaves out (and no longer --data_parallel,
which it has)."""

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
           "densecap_tpu_torch.utils.profiling",
           "densecap_tpu_torch.parallel.distributed",
           "densecap_tpu_torch.utils.checkpoint",
           "densecap_tpu_torch.parallel.mesh",
           "densecap_tpu_torch.utils.t7_reader",
           "densecap_tpu_torch.cli.convert_t7",
           "densecap_tpu_torch.data.preprocess",
           "chip_smoke"]


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'densecap_tpu'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


def test_epilog_names_the_flags_left_out():
    from densecap_tpu_torch.cli import _common, evaluate_model, train

    for flag in ("--roi_align", "--model_parallel", "--uint8_pipe"):
        assert flag in _common.NOT_PORTED
    assert "--data_parallel" not in _common.NOT_PORTED  # ported
    assert "--data_parallel" in evaluate_model.build_argparser().format_help()
    help_text = train.build_argparser().format_help()
    assert "--model_parallel" in help_text  # the epilog
    for flag in ("--checkpoint_start_from", "--canvas_buckets", "--timing",
                 "--profile_dir", "--coordinator_address", "--num_processes",
                 "--process_id"):
        assert flag in help_text
