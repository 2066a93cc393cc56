"""The benchmark's spans and the reading of the profiler's device trace.

Spans are host intervals on `time.time_ns()`, the clock of the profiler's
events: the benchmark's own (`Spans.span`) and the program's `PhaseTimers`
phases (`RecordingTimers` wraps the trainer's timers and records each phase
it times). `DeviceTrace` runs `torch.profiler` over the window with CUDA
activity only, keeps the device events in memory (name, start, end) and
reduces them: device time by kernel name and by bucket, the union of busy
intervals, and the idle gaps between them, each labelled by the innermost
span that holds its middle.

The bucket rules are a copy of fairdiff_torch/utils/trace_summary.py's
(CUDA kernel names onto the JAX package's labels).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import sys
import time
from typing import Iterable, Optional

CUDA_BUCKETS = [
    ("flash-fwd", re.compile(r"qb::flash_fwd_kernel|flash_fwd_f32_kernel")),
    ("flash-dq", re.compile(r"qb::flash_dq_kernel|flash_dq_f32_kernel")),
    ("flash-dkv", re.compile(r"kv::flash_bwd_kv_kernel<[^<>]*\bfalse>|flash_dkv_f32_kernel")),
    ("flash-merged", re.compile(r"kv::flash_bwd_kv_kernel<[^<>]*\btrue>|flash_bwd_merged_f32_kernel")),
    ("geglu", re.compile(r"k4::fwd_kernel|gm::(gemm|dx_reduce)_kernel|geglu_(fwd|dx)_f32_kernel")),
    ("group-norm", re.compile(r"gn_cluster_kernel")),
    ("copy/transpose", re.compile(r"^Memcpy|^Memset|nchwToNhwc|nhwcToNchw|at::native::.*(copy|transpose|CatArray)",
                                  re.I)),
    ("conv", re.compile(r"fprop|dgrad|wgrad|convolve|cudnn|conv2d", re.I)),
    ("matmul", re.compile(r"gemm|gemv|nvjet|xmma|cublas|cutlass", re.I)),
    ("reduce", re.compile(r"at::native::.*reduce_kernel")),
    ("elementwise", re.compile(r"at::native::.*elementwise")),
    ("aten", re.compile(r"at::native::")),
]
FLASH_BUCKETS = ("flash-fwd", "flash-dq", "flash-dkv", "flash-merged")
GEGLU_BUCKETS = ("geglu",)


def bucket(name: str) -> str:
    for label, rx in CUDA_BUCKETS:
        if rx.search(name):
            return label
    return "other"


class Spans:
    """Host spans (name, start ns, end ns), kept in memory."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def total_s(self, name: str, t0: int = 0, t1: Optional[int] = None) -> float:
        """Seconds in spans called `name` that start inside [t0, t1]."""
        t1 = t1 if t1 is not None else 1 << 63
        return sum(b - a for n, a, b in self.items if n == name and t0 <= a <= t1) / 1e9


class RecordingTimers:
    """A stand-in for the program's `PhaseTimers` that times each phase with
    it and records the phase as a span."""

    def __init__(self, timers, spans: Spans):
        self._timers, self._spans = timers, spans

    @property
    def last(self) -> dict[str, float]:
        return self._timers.last

    @contextlib.contextmanager
    def __call__(self, name: str):
        with self._spans.span(name), self._timers(name):
            yield


def union(intervals: Iterable[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merged, sorted [start, end) intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: list[tuple[int, int]], t0: int, t1: int) -> list[tuple[int, int]]:
    return [(max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1]


class Labeller:
    """The innermost span that holds a time (the latest started, of those
    the first to end), else "outside spans": the spans cut into elementary
    segments, each with its label, searched by bisection."""

    def __init__(self, spans: list[tuple[str, int, int]]):
        points = sorted({t for _, a, b in spans for t in (a, b)})
        self.starts = points
        self.labels = []
        for a in points:
            holding = [(-s0, s1, name) for name, s0, s1 in spans if s0 <= a < s1]
            self.labels.append(min(holding)[2] if holding else "outside spans")

    def __call__(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.labels[i] if i >= 0 else "outside spans"


class TraceResult:
    """The reduced device trace of one window [t0, t1] (ns)."""

    def __init__(self, events: list[tuple[str, int, int]], t0: int, t1: int, spans: list[tuple[str, int, int]]):
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e9
        self.n_all = len(events)
        self.events_from_s = (min((a for _, a, _ in events), default=t0) - t0) / 1e9
        self.events_to_s = (max((b for _, _, b in events), default=t0) - t0) / 1e9
        inside = [(n, max(a, t0), min(b, t1)) for n, a, b in events if b > t0 and a < t1]
        self.n_events = len(inside)
        self.by_name: dict[str, float] = collections.defaultdict(float)
        for n, a, b in inside:
            self.by_name[n] += (b - a) / 1e9
        self.by_bucket: dict[str, float] = collections.defaultdict(float)
        for n, s in self.by_name.items():
            self.by_bucket[bucket(n)] += s
        busy = union((a, b) for _, a, b in inside)
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        self.spans = [s for s in spans if s[2] > t0 and s[1] < t1]

    def bucket_s(self, names: Iterable[str]) -> float:
        return sum(self.by_bucket.get(n, 0.0) for n in names)

    def idle_by_label(self) -> dict[str, float]:
        out: dict[str, float] = collections.defaultdict(float)
        label = Labeller(self.spans)
        for a, b in self.gaps:
            out[label((a + b) // 2)] += (b - a) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_bucket.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_label().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


class DeviceTrace:
    """`torch.profiler` with CUDA activity only, over a `with` block. The
    profiler stops when the block ends; `read()` then takes its device events
    into memory (name, start, end), once: a run may leave that to a thread
    of its own while the main thread goes on."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: list[tuple[str, int, int]] = []
        self._prof = None
        self._stopped = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        self._stopped, self._prof = self._prof, None
        print(f"[trace] profiler stopped in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return False

    def read(self) -> list[tuple[str, int, int]]:
        """The device events of the stopped profiler."""
        if self._stopped is not None:
            from torch.autograd import DeviceType

            t0 = time.perf_counter()
            for e in self._stopped.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CPU:
                    start = e.start_ns()
                    self.events.append((e.name(), start, start + e.duration_ns()))
            self._stopped = None
            print(f"[trace] {len(self.events)} device events read in {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
        return self.events
