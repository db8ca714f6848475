"""The GRiT cell at a tiny size on the CPU through `harness.execute`
(`bench_tiny`'s sizes; ViTDet-B and the text decoder at their published
widths, the vocab included, on a 256 px square; 4 final boxes an image
and a 4 x 4 object pool): a sound run is `correct` and its traced run
reads the cell's span metrics; each fault of `control_grit.py`, and its
fp8 reference, is not `correct`; the hand FLOP count of the decoder equals the products the
program runs, counted by `torch.utils.flop_counter`, and the steps'
attention bytes equal what the program hands the attention, at two
shapes; the new readers give None where their spans are absent; a
program without an `lm` field stops the run at once. The full-size
control runs on the card: `python3 benchmark/control_grit.py --workload
infer_grit_b8_1024_p1000 --seeds 1,2,3 --kind <kind>`."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

import bench_tiny
from benchlib import grit, harness, spec

CELL = "infer_grit_b8_1024_p1000"
SEED = 2**31 + 12345
SPAN_METRICS = ("grit.prefix_ms", "grit.decode_ms", "grit.decode_attn_ms",
                "grit.prefix_roofline", "grit.decode_attn_roofline",
                "grit.head_steps", "grit.decode_wait_ms")
METRICS = SPAN_METRICS + ("grit.decode_head_roofline", "mfu.infer_grit",
                          "device.idle_pct.infer_grit")


def tiny(precision="float32"):
    bench, wl, cfg = bench_tiny.tiny(CELL, precision)
    cfg.update(vit_img_size=256, test_final_max_boxes=4, textdec_obj_pool=4)
    wl["check"]["rows"] = 2
    return bench, wl, cfg


def tiny_run(precision="float32", trace=0):
    bench, wl, cfg = tiny(precision)
    return harness.Run(CELL, SEED, 1.0, trace, time.perf_counter(),
                       device="cpu", bench=bench, workload=wl, cfg=cfg)


def test_sound_run_passes_and_reads_its_metrics():
    res = harness.execute(tiny_run(trace=1), chips_checked=False,
                          modules_checked=False)
    assert res["correct"], res["checks"]
    for k in ("token_gap", "lp_err", "feat_err"):
        assert res["checks"][k]["value"] < 1e-4, k
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("grit.prefix_ms", "grit.decode_ms", "grit.decode_attn_ms",
                 "grit.prefix_roofline", "grit.decode_attn_roofline",
                 "mfu.infer_grit"):
        assert m[name] > 0, name
    assert m["grit.decode_ms"] > m["grit.decode_attn_ms"]
    assert m["grit.decode_wait_ms"] >= 0
    for name in ("grit.head_steps", "grit.decode_head_roofline"):
        assert name not in m, name  # K4 runs on the card only


@pytest.mark.parametrize("kind", ["bf16", "prefix_layer", "shift", "fp8",
                                  "fp8_ref"])
def test_control_faults_are_rejected(kind):
    """The program as it is (bf16) within every limit; each fault, and the
    fp8 reference in the program's place, over `token_gap` or
    `lp_err`."""
    import control_grit

    run = tiny_run("bfloat16")
    limits = run.workload["limits"]
    got = control_grit.readings(run, kind, 0.5)
    if kind == "bf16":
        assert all(got[k] <= v for k, v in limits.items()), got
    else:
        assert any(got[k] > limits[k] for k in ("token_gap", "lp_err")), got


def _program(cfg):
    """The program's model of a tiny cell's configuration, f32, with the
    seed's weights."""
    from benchlib import program
    from densecap_tpu_torch.utils.checkpoint import to_torch

    pcfg = program.program_config(cfg)
    return to_torch(grit.weights_numpy(cfg, SEED, torch.device("cpu")),
                    pcfg, torch.device("cpu"))


@pytest.mark.parametrize("shape", [
    dict(textdec_obj_pool=4, test_final_max_boxes=3, steps=5),
    dict(textdec_obj_pool=3, test_final_max_boxes=2, steps=7,
         textdec_layers=3, textdec_dim=128, textdec_heads=2, textdec_ffn=96,
         vocab_size=50, vit_out_channels=24)])
def test_counts_equal_what_the_program_runs(shape):
    """The prefill's FLOPs and each step's (its head included), counted
    over the program's own products and attention (SDPA's math path);
    the steps' attention bytes, summed over the tensors the program hands
    the attention in bf16."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.utils.flop_counter import FlopCounterMode

    _, _, cfg = tiny()
    steps = shape.pop("steps")
    cfg.update(shape, seq_length=steps, compute_dtype="float32")
    model = _program(cfg)
    lm, B = model.lm, 2
    M = grit.final_rows(cfg)
    C_f = cfg["vit_out_channels"]
    g = torch.Generator().manual_seed(0)
    feats = torch.randn((B, 16, 16, C_f), generator=g)
    boxes = torch.rand((B, M, 4), generator=g) * 100 + 20
    hw = torch.full((B,), 256.0)
    extent = model.feat_extent(hw, hw)
    seen = []
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def attend(q, k, v):
        if q.shape[2] == 1:  # a step
            seen.append(2 * (q.numel() + k.numel() + v.numel() + q.numel()))
        return sdpa(q, k, v)

    with torch.no_grad(), sdpa_kernel(SDPBackend.MATH):
        with FlopCounterMode(display=False) as fc:
            cache = lm.prefill(feats, boxes, hw, hw, extent, steps)
        assert fc.get_total_flops() == grit.prefix_flops(cfg, B * M)
        tok = torch.full((B * M,), lm.vocab_size + 1)
        torch.nn.functional.scaled_dot_product_attention = attend
        try:
            for t in range(steps):
                with FlopCounterMode(display=False) as fc:
                    tok = lm.project(lm.step(tok, t, cache)).argmax(1) + 1
                assert fc.get_total_flops() == grit.step_flops(cfg, B * M,
                                                               t), t
        finally:
            torch.nn.functional.scaled_dot_product_attention = sdpa
    assert sum(seen) == grit.decode_attn_bytes(cfg, B, steps)
    parts = grit.inference_flops(cfg, B, steps)
    assert parts["prefix"] == grit.prefix_flops(cfg, B * M)
    assert parts["total"] == sum(v for k, v in parts.items() if k != "total")


def test_readers_give_none_without_their_spans():
    """A run with no window (no store to read), and the ViTDet cell's
    traced run, whose program opens no text decoder span."""
    empty = tiny_run()
    for name in METRICS:
        assert spec.metric_reader(name).read(empty) is None, name
    bench, wl, cfg = bench_tiny.tiny("infer_vitdet_b8_1024_p1000")
    cfg.update(vit_img_size=256)
    run = harness.Run("infer_vitdet_b8_1024_p1000", SEED, 1.0, 1,
                      time.perf_counter(), device="cpu", bench=bench,
                      workload=wl, cfg=cfg)
    harness.execute(run, chips_checked=False, modules_checked=False)
    for name in SPAN_METRICS:
        assert spec.metric_reader(name).read(run) is None, name


def test_a_program_without_the_lm_field_stops_at_once(monkeypatch):
    from densecap_tpu_torch import config

    @dataclasses.dataclass(frozen=True)
    class Old:
        trunk: str = "vitdet_b"

    monkeypatch.setattr(config, "DenseCapConfig", Old)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        harness.execute(tiny_run(), chips_checked=False,
                        modules_checked=False)
    assert e.value.code == 2
    assert time.perf_counter() - t0 < 5.0


def test_counts_at_the_cell():
    """The decoder's count at the cell's shape (800 rows): the prefill
    ~13.3 TFLOP, as the configuration's sizing has it less the last
    layer's work past its k and v; a step's attention reads ~2.9 GB."""
    cfg = spec.load_json(bench_tiny.BENCH / "configs"
                         / "densecap_grit_b_1024_p1000.json")
    rows = 8 * grit.final_rows(cfg)
    assert rows == 800
    full_layer = 2 * 196 * rows * 7077888 + 4 * rows * 196 ** 2 * 768
    assert grit.prefix_flops(cfg, rows) == (
        2 * rows * 196 * 256 * 768 + 6 * full_layer
        - (full_layer - 2 * 196 * rows * 768 * 1536))
    assert 11.5e12 < grit.prefix_flops(cfg, rows) < 12.5e12
    one = grit.decode_attn_bytes(cfg, 8, 1)
    assert one == 6 * rows * 768 * 2 * (2 * 197 + 2)
    assert 2.9e9 < one < 3.0e9
