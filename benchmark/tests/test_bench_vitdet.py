"""The ViTDet cell at a tiny size on the CPU through `harness.execute`
(`bench_tiny`'s sizes; the ViT at its published widths on a 256 px
square, so the windowed blocks pad 16 to 28): a sound run is `correct`
and its traced run reads the cell's span metrics; the program without
its relative-position terms is not `correct` (`feat_err`); the fp8
reference in the program's place reads at least three times what the
program (bf16) reads on one compared number, and the cell's limits
reject it; a program without a `trunk` field stops the run at once. The
full-size control runs on the card: `python3 benchmark/control_vitdet.py
--workload infer_vitdet_b8_1024_p1000 --seeds 1,2,3 --kind <kind>`."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

import bench_tiny
from benchlib import harness, vitdet

CELL = "infer_vitdet_b8_1024_p1000"
SEED = 2**31 + 12345


def tiny(precision="float32"):
    bench, wl, cfg = bench_tiny.tiny(CELL, precision)
    cfg.update(vit_img_size=256)
    return bench, wl, cfg


def run_tiny(precision="float32", trace=0, seed=SEED):
    bench, wl, cfg = tiny(precision)
    run = harness.Run(CELL, seed, 1.0, trace, time.perf_counter(),
                      device="cpu", bench=bench, workload=wl, cfg=cfg)
    return harness.execute(run, chips_checked=False, modules_checked=False)


def test_sound_run_passes_and_reads_its_metrics():
    res = run_tiny(trace=1)
    assert res["correct"], res["checks"]
    assert res["checks"]["feat_err"]["value"] < 1e-5
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("vitdet.trunk_ms", "vitdet.global_attn_ms",
                 "vitdet.window_attn_ms", "vitdet.mlp_ms",
                 "vitdet.global_attn_roofline", "mfu.infer_vitdet"):
        assert m[name] > 0, name
    assert m["vitdet.trunk_ms"] > (m["vitdet.global_attn_ms"]
                                   + m["vitdet.window_attn_ms"]
                                   + m["vitdet.mlp_ms"])


def test_program_without_relative_positions_fails(monkeypatch):
    """The program with its relative-position tables zeroed after the
    build (as `batch_infer_vitdet.Driver.rel_pos` does): not `correct`,
    by `feat_err`; the same run with them is."""
    from densecap_tpu_torch.utils import checkpoint

    build = checkpoint.to_torch

    def bare(*a, **kw):
        model = build(*a, **kw)
        for blk in model.vit.blocks:
            blk.attn.rel_h.zero_()
            blk.attn.rel_w.zero_()
        return model

    monkeypatch.setattr(checkpoint, "to_torch", bare)
    res = run_tiny(precision="bfloat16")
    assert not res["correct"]
    feat = res["checks"]["feat_err"]
    assert feat["value"] > feat["limit"], res["checks"]
    monkeypatch.undo()
    sound = run_tiny(precision="bfloat16")
    assert sound["correct"], sound["checks"]


def test_fp8_reference_reads_above_the_sound_program():
    import control_vitdet

    bench, wl, cfg = tiny()
    run = harness.Run(CELL, SEED, 1.0, 0, time.perf_counter(), device="cpu",
                      bench=bench, workload=wl, cfg=cfg)
    low = control_vitdet.readings(run, "fp8", torch.device("cpu"))
    sound = run_tiny(precision="bfloat16")["checks"]
    assert any(k in low and low[k] >= 3 * sound[k]["value"] > 0
               for k in sound), (low, sound)
    assert any(k in low and low[k] > v["limit"]
               for k, v in sound.items()), low


def test_a_program_without_the_trunk_field_stops_at_once(monkeypatch):
    from densecap_tpu_torch import config

    @dataclasses.dataclass(frozen=True)
    class Old:
        vocab_size: int = 1000

    monkeypatch.setattr(config, "DenseCapConfig", Old)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        run_tiny()
    assert e.value.code == 2
    assert time.perf_counter() - t0 < 5.0


def test_flop_count_at_the_cell():
    """The trunk's count at the cell's shape: ViTDet-B at B=8, 1024 px."""
    cfg = bench_tiny.spec.load_json(bench_tiny.BENCH / "configs" /
                                    "densecap_vitdet_b_1024_p1000.json")
    t = vitdet.trunk_flops(cfg, 8)
    # 4 global blocks: 4 B h N^2 d + 4 B h N S d each
    assert t["global_attn"] == 4 * (4 * 8 * 12 * 4096 ** 2 * 64
                                    + 4 * 8 * 12 * 4096 * 64 * 64)
    assert 5.6e12 < t["linear"] < 6.0e12
    assert 7.6e12 < t["total"] < 7.8e12
    ms = vitdet.global_attn_least_ms(cfg, 8)
    assert ms == pytest.approx(t["global_attn"] / 4 / 989e12 * 1e3)
