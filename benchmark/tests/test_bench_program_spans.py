"""The readers of the program's own spans (`metrics/_program.py` and the six
metrics on it): their values on synthetic spans and idle gaps, nothing
where the program records no span, and their values on the spans a real
tiny `train_step`, `generate` and `save_image` recorded on the CPU, read
against synthetic device gaps."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness.record import RunRecord
from benchmark.harness.spec import cell, driver, load_bench, metric_reader
from benchmark.harness.trace import Spans, TraceResult, union
from benchmark.metrics import _program

MS = 1_000_000  # ns
T = 1_000 * MS
SEED = 2**31 + 7
TRAIN = ("pair_vjp_ms.train", "pair_vjp_idle_share.train", "analyze_s_per_step.train")
GEN = ("unet_call_idle_ms.gen", "condition_ms.gen", "save_image_share.gen")


def _span(i, name, t0_ms, t1_ms, parent=None, device_ms=None):
    return SimpleNamespace(id=i, name=name, parent=parent, t0_ns=T + t0_ms * MS, t1_ns=T + t1_ms * MS,
                           device_ns=None if device_ms is None else device_ms * MS)


def _busy(*intervals_ms):
    return [("kernel", T + a * MS, T + b * MS) for a, b in intervals_ms]


def _record(kind, name, window_ms, trace):
    c = cell(name, load_bench())
    window_ns = (T + window_ms[0] * MS, T + window_ms[1] * MS)
    return RunRecord(kind, c["config"], c["traffic"], (window_ns[1] - window_ns[0]) / 1e9, [], Spans(), window_ns,
                     0, trace)


def _train_run():
    """A 300-ms window: an untraced step [0, 100), the traced step [100, 300]."""
    spans = [
        _span(1, "pair_vjp", 10, 20, device_ms=8), _span(2, "pair_vjp", 30, 40, device_ms=12),
        _span(3, "phase1_sample_analyze", 50, 70), _span(4, "analyze", 51, 60, 3, device_ms=5),
        _span(5, "phase3_frozen_sample", 70, 90), _span(6, "analyze", 71, 80, 5, device_ms=7),
        _span(7, "loss_vjp", 90, 99), _span(8, "analyze", 91, 95, 7, device_ms=100),  # phase 4's: left out
        _span(9, "pair_vjp", 110, 130, device_ms=50), _span(10, "pair_vjp", 150, 160, device_ms=50),
    ]
    # idle 115-125 (10 ms in the first traced pair), 155-158 (3 ms in the second)
    trace = TraceResult(_busy((100, 115), (125, 155), (158, 300)), T + 100 * MS, T + 300 * MS, [])
    return _record("train", "train-exp1", (0, 300), trace), spans


def _gen_run():
    """A 200-ms traced window of two `generate` calls."""
    spans = [
        _span(1, "generate", 0, 90), _span(2, "encode_prompt", 1, 5, 1, device_ms=4),
        _span(3, "merge_lora", 5, 15, 1, device_ms=10), _span(4, "denoise", 15, 80, 1),
        _span(5, "unet_call", 20, 30, 4), _span(6, "unet_call", 40, 50, 4),
        _span(7, "save_image", 90, 95), _span(8, "save_image", 95, 100),
        _span(9, "generate", 100, 190), _span(10, "encode_prompt", 101, 105, 9, device_ms=6),
        _span(11, "merge_lora", 105, 115, 9, device_ms=10), _span(12, "denoise", 115, 180, 9),
        _span(13, "unet_call", 120, 130, 12),
        _span(14, "phase4_pair_vjp", 195, 199), _span(15, "encode_prompt", 196, 197, 14, device_ms=99),
    ]
    # idle 25-35 (5 ms in the first call) and 122-127 (5 ms in the third)
    trace = TraceResult(_busy((0, 25), (35, 122), (127, 200)), T, T + 200 * MS, [])
    return _record("gen", "gen-unet-lora", (0, 200), trace), spans


def test_readers_on_synthetic_spans_and_gaps(monkeypatch):
    run, spans = _train_run()
    monkeypatch.setattr(_program, "program_spans", lambda: spans)
    assert metric_reader("pair_vjp_ms.train")(run) == pytest.approx(10.0)
    assert metric_reader("pair_vjp_idle_share.train")(run) == pytest.approx(100 * 13 / 30)
    assert metric_reader("analyze_s_per_step.train")(run) == pytest.approx(0.012)
    for name in GEN:
        assert metric_reader(name)(run) is None  # a training run has none
    run, spans = _gen_run()
    monkeypatch.setattr(_program, "program_spans", lambda: spans)
    assert metric_reader("unet_call_idle_ms.gen")(run) == pytest.approx(10 / 3)
    assert metric_reader("condition_ms.gen")(run) == pytest.approx((4 + 10 + 6 + 10) / 2)
    assert metric_reader("save_image_share.gen")(run) == pytest.approx(100 * 10 / 200)
    for name in TRAIN:
        assert metric_reader(name)(run) is None


def test_idle_clipped_to_spans_across_several_gaps():
    gaps = [(0, 10), (20, 30), (40, 50)]
    spans = [SimpleNamespace(t0_ns=5, t1_ns=25), SimpleNamespace(t0_ns=29, t1_ns=60),
             SimpleNamespace(t0_ns=60, t1_ns=70)]
    assert _program.idle_s(gaps, spans) == pytest.approx((5 + 5 + 1 + 10) / 1e9)


@pytest.mark.parametrize("build", [_train_run, _gen_run])
def test_every_reader_returns_nothing_without_program_spans(build, monkeypatch):
    run, _ = build()
    monkeypatch.setattr(_program, "program_spans", lambda: [])
    for name in TRAIN + GEN:
        assert metric_reader(name)(run) is None
    # a program without the recorder (an older commit) gives no spans either
    from fairdiff_torch.utils import profiling

    monkeypatch.undo()
    monkeypatch.delattr(profiling, "recorded_spans")
    assert _program.program_spans() == []
    for name in TRAIN + GEN:
        assert metric_reader(name)(run) is None


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program_run(name):
    """An untraced run of the tiny cell on the CPU, and the program spans it
    recorded in its window."""
    from benchmark import run as bench_run
    from benchmark.tests.tiny import tiny_cell
    from fairdiff_torch.utils.profiling import recorded_spans

    c = tiny_cell(name)
    ctx = bench_run.Context(c, SEED, 0.1, False, "cpu", time.perf_counter())
    record = driver(c["traffic"]["kind"]).run(ctx)["record"]
    return record, [s for s in recorded_spans() if record.window_ns[0] <= s.t0_ns < record.window_ns[1]]


def test_readers_on_a_tiny_training_run(_one_thread):
    record, spans = _program_run("train-exp1")
    steps = sorted((s for s in spans if s.name == "train_step"), key=lambda s: s.t0_ns)
    assert len(steps) >= 2
    last = steps[-1]
    # the last step as the traced one, the device busy only in the UNet backward passes
    backward = [(s.t0_ns, s.t1_ns) for s in spans if s.name == "unet_backward" and s.root == last.id]
    record.trace = TraceResult([("kernel", a, b) for a, b in backward], last.t0_ns, last.t1_ns, [])
    first = [s for s in spans if s.t0_ns < last.t0_ns]
    pairs = [s for s in first if s.name == "pair_vjp"]
    assert pairs and all(s.device_ns == s.t1_ns - s.t0_ns for s in pairs)  # the CPU's device time
    assert metric_reader("pair_vjp_ms.train")(record) == pytest.approx(
        sum(s.device_ns for s in pairs) / len(pairs) / 1e6)
    traced = [s for s in spans if s.name == "pair_vjp" and s.root == last.id]
    host = sum(s.t1_ns - s.t0_ns for s in traced)
    inside = sum(b - a for a, b in union(backward))
    assert metric_reader("pair_vjp_idle_share.train")(record) == pytest.approx(100 * (host - inside) / host)
    phase = {s.id: s.name for s in first}
    analyze = [s for s in first if s.name == "analyze"
               and phase.get(s.parent) in ("phase1_sample_analyze", "phase3_frozen_sample")]
    assert len(analyze) == 2 * (len(steps) - 1)
    assert metric_reader("analyze_s_per_step.train")(record) == pytest.approx(
        sum(s.device_ns for s in analyze) / 1e9)


def test_readers_on_a_tiny_generation_run(_one_thread):
    record, spans = _program_run("gen-unet-lora")
    calls = [s for s in spans if s.name == "unet_call"]
    # the device idle in the first half of each UNet call
    busy = [(record.window_ns[0], record.window_ns[0] + 1)] + [((a + b) // 2, b) for a, b in
                                                               ((s.t0_ns, s.t1_ns) for s in calls)]
    record.trace = TraceResult([("kernel", a, b) for a, b in busy], *record.window_ns, [])
    gens = [s for s in spans if s.name == "generate"]
    assert gens and len(calls) == len(gens) * record.traffic["denoising_steps"]
    assert metric_reader("unet_call_idle_ms.gen")(record) == pytest.approx(
        sum((b - a) // 2 for a, b in ((s.t0_ns, s.t1_ns) for s in calls)) / len(calls) / 1e6, rel=1e-6)
    cond = [s for s in spans if s.name in ("encode_prompt", "merge_lora")]
    assert {s.name for s in cond} == {"encode_prompt", "merge_lora"}
    assert metric_reader("condition_ms.gen")(record) == pytest.approx(
        sum(s.device_ns for s in cond) / len(gens) / 1e6)
    saves = [s for s in spans if s.name == "save_image"]
    assert len(saves) == sum(w["images"] for w in record.work)
    assert metric_reader("save_image_share.gen")(record) == pytest.approx(
        100 * sum(s.t1_ns - s.t0_ns for s in saves) / 1e9 / record.window_s)
