"""The metric arithmetic on a synthetic profiler trace: the idle union,
the bucket names, the idle gaps' labels, the roofline and mfu sums."""

from __future__ import annotations

import pytest

from benchmark.harness import arith
from benchmark.harness.record import RunRecord
from benchmark.harness.spec import cell, load_bench, metric_reader
from benchmark.harness.trace import Spans, TraceResult, bucket, union

MS = 1_000_000  # ns


def test_union_merges_overlaps_and_touching_intervals():
    assert union([(5, 9), (0, 3), (2, 4), (9, 12), (20, 21)]) == [(0, 4), (5, 12), (20, 21)]


def test_bucket_names():
    assert bucket("void qb::flash_fwd_kernel<48>(Params)") == "flash-fwd"
    assert bucket("void kv::flash_bwd_kv_kernel<48, false>(Params)") == "flash-dkv"
    assert bucket("void kv::flash_bwd_kv_kernel<160, true>(Params)") == "flash-merged"
    assert bucket("void k4::fwd_kernel<64, 128>(Maps)") == "geglu"
    assert bucket("void gm::gemm_kernel<1>(Maps)") == "geglu"
    assert bucket("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64") == "matmul"
    assert bucket("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(...)") == "copy/transpose"
    assert bucket("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert bucket("void at::native::vectorized_elementwise_kernel<4, ...>") == "elementwise"
    assert bucket("Memcpy HtoD (Pageable -> Device)") == "copy/transpose"
    assert bucket("something else") == "other"


def _trace():
    """A 100 ms window: flash 10 ms and 5 ms (overlapping a matmul), GEGLU
    4 ms, a matmul 20 ms; busy 10 + 20 + 4 = 34 ms after the union."""
    t0 = 1_000 * MS
    ev = [
        ("void qb::flash_fwd_kernel<48>(P)", t0 + 0, t0 + 10 * MS),
        ("void kv::flash_bwd_kv_kernel<48, false>(P)", t0 + 30 * MS, t0 + 35 * MS),
        ("sm90_xmma_gemm_bf16", t0 + 30 * MS, t0 + 50 * MS),
        ("void k4::fwd_kernel<64, 128>(M)", t0 + 60 * MS, t0 + 64 * MS),
        ("sm90_xmma_gemm_bf16", t0 - 5 * MS, t0 - 1 * MS),  # before the window: left out
    ]
    spans = [("phase1_sample_analyze", t0, t0 + 55 * MS), ("train_step", t0, t0 + 100 * MS)]
    return TraceResult(ev, t0, t0 + 100 * MS, spans), t0


def test_trace_result_busy_gaps_and_labels():
    tr, t0 = _trace()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.034)
    assert tr.bucket_s(("flash-fwd", "flash-dkv")) == pytest.approx(0.015)
    assert tr.by_bucket["matmul"] == pytest.approx(0.020)
    idle = tr.idle_by_label()
    # gaps 10-30 (middle 20: phase 1), 50-60 (middle 55: phase 1 has ended)
    # and 64-100, each labelled by the span that holds its middle
    assert idle == pytest.approx({"phase1_sample_analyze": 0.020, "train_step": 0.046})
    b = tr.breakdown()
    assert b["device_ops"][0] == ["matmul", pytest.approx(0.02)]
    assert b["idle_gaps"][0] == ["train_step", pytest.approx(0.046)]


def _record(kind: str, tr: TraceResult, work: list[dict], name: str, traced=None) -> RunRecord:
    c = cell(name, load_bench())
    spans = Spans()
    spans.items = list(tr.spans) + [("save_image", tr.t0 + 70 * MS, tr.t0 + 80 * MS)]
    return RunRecord(kind, c["config"], c["traffic"], tr.window_s, work, spans, (tr.t0, tr.t1), 3 * 2**30, tr,
                     traced)


def test_roofline_and_idle_readers_on_the_synthetic_trace():
    tr, _ = _trace()
    # a traced training run: an untraced step (the PhaseTimers readers and
    # mfu), then the traced one (the trace's readers)
    work = [{"n_steps": 2, "wall_s": 4.0, "phases": {"phase4_backward": 1.5, "phase1_sample_analyze": 0.25,
                                                     "phase3_frozen_sample": 0.5}}]
    traced = [{"n_steps": 2, "wall_s": 9.0, "phases": {"phase4_backward": 7.0, "phase1_sample_analyze": 1.0,
                                                       "phase3_frozen_sample": 1.0}}]
    run = _record("train", tr, work, "train-exp1", traced)
    u = run.sd_config.unet
    rows = 2 * 12 * 2
    f_fwd, g_fwd = arith.unet_bounds_s(u, rows, False)
    f_grad, g_grad = arith.unet_bounds_s(u, rows, True)
    assert metric_reader("flash_roofline.train")(run) == pytest.approx(100 * (2 * f_fwd + f_grad) / 0.015)
    assert metric_reader("geglu_roofline.train")(run) == pytest.approx(100 * (2 * g_fwd + g_grad) / 0.004)
    assert metric_reader("device_idle_share.train")(run) == pytest.approx(66.0)
    # scaled to a step of exp1-step's middle count, 21 denoising steps
    assert metric_reader("phase4_s_per_step.train")(run) == pytest.approx(1.5 * 21 / 2)
    assert metric_reader("sample_s_per_step.train")(run) == pytest.approx(0.75 * 21 / 2)
    f = {k: 1.0e12 for k in ("unet", "unet_vjp", "te", "te_vjp", "decode", "analyze", "analyze_full", "loss_vjp")}
    run.__dict__["unit_flops"] = f  # the cached count, without the meta run
    assert metric_reader("mfu.train")(run) == pytest.approx(
        100 * arith.train_step_flops(f, 12, 2) / (4.0 * arith.PEAK_BF16_FLOPS))
    assert metric_reader("peak_mem_gib.train")(run) == 3.0
    for gen_only in ("flash_roofline.gen", "device_idle_share.gen", "jpeg_write_share.gen", "mfu.gen"):
        assert metric_reader(gen_only)(run) is None


def test_gen_readers_and_mfu_sum():
    tr, _ = _trace()
    work = [{"images": 10, "n_steps": 30}, {"images": 10, "n_steps": 30}]
    run = _record("gen", tr, work, "gen-unet-lora")
    f = {"unet": 1.0e12, "te": 1.0e10, "decode": 2.0e12}
    run.__dict__["unit_flops"] = f  # the cached count, without the meta run
    flops = 2 * (2 * 1e10 + 2 * 10 * 30 * 1e12 + 10 * 2e12)
    assert metric_reader("mfu.gen")(run) == pytest.approx(100 * flops / (0.1 * 989e12))
    assert metric_reader("jpeg_write_share.gen")(run) == pytest.approx(10.0)
    fa, ge = arith.unet_bounds_s(run.sd_config.unet, 2 * 10 * 30, False)
    assert metric_reader("flash_roofline.gen")(run) == pytest.approx(100 * 2 * fa / 0.015)


def test_a_reader_with_nothing_to_read_returns_nothing():
    tr = TraceResult([], 0, 100 * MS, [])
    run = _record("gen", tr, [], "gen-unet-lora")
    for name in ("flash_roofline.gen", "geglu_roofline.gen", "device_idle_share.gen", "mfu.gen"):
        assert metric_reader(name)(run) is None
