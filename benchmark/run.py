"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 a breakdown, and
last the numbers compared with the reference beside their limits (also
the last lines of standard error). Exits non-zero, with no result, when
there is no CUDA card or fewer than the cell needs, when the program is
not in the checkout, or when JAX or the JAX package was loaded.

Every cache of the program's build stays inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from benchlib import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "densecap_tpu_torch").is_dir():
        raise harness.Failure("the program (densecap_tpu_torch) is not in "
                              "the checkout")
    run = harness.Run(args.workload, args.seed, args.seconds, args.trace,
                      T_START)
    harness.report(harness.execute(run))


if __name__ == "__main__":
    main()
