"""The port's real-artifact runbook (`scripts/torch_real_eval.py`) on
mocked artifacts, beside the JAX runbook's tests (tests/test_real_eval.py):

  * missing artifacts are reported with where the reference gets them,
    and the runbook exits 1;
  * end to end on a miniature DenseCap t7 in the reference's
    serialization and a synthetic mini Visual Genome (the JAX test's
    own stand-ins): check -> convert_t7 -> run_model smoke ->
    preprocess -> evaluate_model, on the CPU, each step leaving its
    artifact; the port's test-split mAP and detmap equal the JAX
    runbook's on the same artifacts within 1e-6 (the tolerance of
    tests/test_torch_cli_eval.py); a rerun skips the finished steps.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from test_real_eval import _load_real_eval, _write_mini_t7, _write_mini_vg

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_real_eval  # noqa: E402


def test_check_reports_missing(tmp_path, capsys):
    rc = torch_real_eval.main([
        "--t7", str(tmp_path / "nope.t7"),
        "--region_data", str(tmp_path / "nope.json"),
        "--image_dir", str(tmp_path / "noimgs"),
        "--jar", str(tmp_path / "nope.jar"),
        "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert rc == 1
    assert "MISSING" in out
    assert "download_pretrained_model.sh" in out
    assert "setup_eval.sh" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["missing"] == ["pretrained .t7", "VG region JSON",
                               "VG image dir", "METEOR jar"]


def test_runbook_end_to_end_with_mocked_artifacts(tmp_path):
    t7_path = tmp_path / "mini-pretrained.t7"
    _write_mini_t7(str(t7_path))
    region_data, image_dir, split_json = _write_mini_vg(tmp_path)
    smoke = os.path.join(image_dir, "500.jpg")
    common = ["--t7", str(t7_path), "--region_data", region_data,
              "--image_dir", image_dir, "--split_json", split_json,
              "--image_size", "64", "--min_token_instances", "1",
              "--num_proposals", "8", "--max_images", "1",
              "--allow_fallback_scorer"]
    ref_dir, workdir = tmp_path / "jax", tmp_path / "port"
    assert _load_real_eval().main(common + ["--smoke_image", smoke,
                                            "--workdir", str(ref_dir)]) == 0
    port = common + ["--workdir", str(workdir), "--num_workers", "2",
                     "--device", "cpu"]
    assert torch_real_eval.main(port + ["--smoke_image", smoke]) == 0

    assert (workdir / "pretrained.npz").exists()
    with open(workdir / "smoke" / "results.json") as f:
        smoke_res = json.load(f)["results"]
    assert smoke_res and smoke_res[0]["captions"]
    assert (workdir / "VG-regions.h5").exists()
    with open(workdir / "eval_results.json") as f:
        got = json.load(f)["ap_results"]
    with open(ref_dir / "eval_results.json") as f:
        ref = json.load(f)["ap_results"]
    assert np.isfinite(float(got["map"]))
    for key in ("map", "detmap"):
        assert got[key] == pytest.approx(ref[key], rel=0, abs=1e-6)

    # a rerun skips the finished steps and still succeeds
    assert torch_real_eval.main(port + ["--smoke_image", ""]) == 0
