"""Shared by the readers of the program's own spans
(fairdiff_torch/utils/profiling.py `recorded_spans`: each span's name, id,
parent id, host start and end on the profiler's clock, and device-stream
duration): the spans of a time range and the trace's idle time inside
them. A program without the recorder, or without such spans, gives
nothing to read, and each reader then returns None."""

from __future__ import annotations

import bisect


def program_spans() -> list:
    """The program's recorded spans; [] where it records none."""
    try:
        from fairdiff_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded_spans", None)
    return list(recorded()) if recorded is not None else []


def untraced_step(run) -> tuple[int, int]:
    """A traced training run's untraced window step [window start, trace
    start); an untraced run's whole window."""
    return (run.window_ns[0], run.trace.t0) if run.trace is not None else run.window_ns


def traced(run) -> tuple[int, int]:
    return run.trace.t0, run.trace.t1


def spans_in(t0: int, t1: int, names: tuple[str, ...], parents: tuple[str, ...] = ()) -> list:
    """The spans called one of `names` that start in [t0, t1), with a
    parent called one of `parents` where that is given."""
    spans = program_spans()
    name_of = {s.id: s.name for s in spans} if parents else {}
    return [s for s in spans if s.name in names and t0 <= s.t0_ns < t1
            and (not parents or name_of.get(s.parent) in parents)]


def device_s(spans: list) -> list[float]:
    """The device-stream seconds of each span that has one."""
    return [s.device_ns / 1e9 for s in spans if s.device_ns is not None]


def idle_s(gaps: list[tuple[int, int]], spans: list) -> float:
    """Seconds of the trace's idle gaps (sorted, disjoint) inside the
    spans (disjoint)."""
    starts = [a for a, _ in gaps]
    total = 0
    for s in spans:
        i = max(bisect.bisect_right(starts, s.t0_ns) - 1, 0)
        while i < len(gaps) and gaps[i][0] < s.t1_ns:
            a, b = gaps[i]
            total += max(0, min(b, s.t1_ns) - max(a, s.t0_ns))
            i += 1
    return total / 1e9


def host_s(spans: list) -> float:
    return sum(s.t1_ns - s.t0_ns for s in spans) / 1e9
