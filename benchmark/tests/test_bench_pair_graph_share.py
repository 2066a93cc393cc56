"""The reader of `pair_vjp_graph_share.train`: the share of the untraced
window step's "pair_vjp" spans that have a "graph_replay" child, on
synthetic spans (all, some, none, and nothing without "pair_vjp" spans or
outside a training run) and on a tiny training run on the CPU, whose pair
VJPs run eagerly."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness.record import RunRecord
from benchmark.harness.spec import cell, load_bench, metric_reader
from benchmark.harness.trace import Spans, TraceResult
from benchmark.metrics import _program

NAME = "pair_vjp_graph_share.train"
MS = 1_000_000  # ns
T = 1_000 * MS


def _span(i, name, t0_ms, t1_ms, parent=None):
    return SimpleNamespace(id=i, name=name, parent=parent, t0_ns=T + t0_ms * MS, t1_ns=T + t1_ms * MS,
                           device_ns=None)


def _run(kind="train", name="train-exp1"):
    """A 300-ms window: an untraced step [0, 100), the traced step [100, 300]."""
    c = cell(name, load_bench())
    trace = TraceResult([("kernel", T, T + 300 * MS)], T + 100 * MS, T + 300 * MS, [])
    return RunRecord(kind, c["config"], c["traffic"], 0.3, [], Spans(), (T, T + 300 * MS), 0, trace)


def _pairs(children):
    """Four pair VJPs in the untraced step, the i-th with the child
    `children[i]` (None: no child), and one in the traced step that replays."""
    spans = []
    for i, child in enumerate(children):
        spans.append(_span(10 * i + 1, "pair_vjp", 10 * i, 10 * i + 8))
        if child:
            spans.append(_span(10 * i + 2, child, 10 * i + 1, 10 * i + 7, parent=10 * i + 1))
    return spans + [_span(100, "pair_vjp", 150, 160), _span(101, "graph_replay", 151, 159, parent=100)]


@pytest.mark.parametrize("children,share", [
    (["graph_replay"] * 4, 100.0),
    (["graph_capture", "graph_replay", "graph_replay", "graph_replay"], 75.0),
    (["unet_forward", None, "unet_backward", "graph_replay"], 25.0),
    (["unet_forward"] * 4, 0.0),
])
def test_share_of_pair_vjps_that_replay(children, share, monkeypatch):
    spans = _pairs(children)
    monkeypatch.setattr(_program, "program_spans", lambda: spans)
    assert metric_reader(NAME)(_run()) == pytest.approx(share)


def test_replay_spans_elsewhere_do_not_count(monkeypatch):
    spans = [_span(1, "pair_vjp", 0, 8), _span(2, "phase4_pair_vjp", 10, 20),
             _span(3, "graph_replay", 11, 19, parent=2)]
    monkeypatch.setattr(_program, "program_spans", lambda: spans)
    assert metric_reader(NAME)(_run()) == 0.0


@pytest.mark.parametrize("spans", [[], [_span(1, "unet_call", 0, 8)], [_span(1, "pair_vjp", 150, 160)]])
def test_nothing_without_pair_vjps_in_the_untraced_step(spans, monkeypatch):
    monkeypatch.setattr(_program, "program_spans", lambda: spans)
    assert metric_reader(NAME)(_run()) is None


def test_nothing_in_a_generation_run(monkeypatch):
    spans = _pairs(["graph_replay"] * 4)
    monkeypatch.setattr(_program, "program_spans", lambda: spans)
    assert metric_reader(NAME)(_run("gen", "gen-unet-lora")) is None


def test_nothing_without_the_recorder(monkeypatch):
    from fairdiff_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded_spans")
    assert metric_reader(NAME)(_run()) is None


def test_zero_on_a_tiny_training_run_on_the_cpu():
    from benchmark.tests.test_bench_program_spans import _program_run

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        record, spans = _program_run("train-exp1")
    finally:
        torch.set_num_threads(n)
    assert any(s.name == "pair_vjp" for s in spans)
    assert metric_reader(NAME)(record) == 0.0
