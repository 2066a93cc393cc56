"""Tracing and profiling helpers (counterpart of fairdiff/utils/profiling.py).

Usage:
    with span("pair_vjp"):                  # recorded, always on
        ...
    spans = recorded_spans()                # with their device durations

    with trace_to("outputs/trace", device=sd.device):   # a Chrome trace
        state = trainer.fit(state, prompt_ids, max_steps=1)

    timers = PhaseTimers(device)
    with timers("phase1"):
        ...
    print(timers.last)

The span recorder keeps every span the program enters (its name, id, the
ids of its parent and of its root, its host start and end on
`time.time_ns()`, the clock of `torch.profiler`'s events) in a bounded
buffer. On a CUDA device each span also records a timing event on the
current stream at its start and at its end, and its device-stream
duration is read once both events have completed (`Event.query()`), as
the program goes on or when the spans are read: nothing synchronises.
While the stream is capturing a CUDA graph a span records no event, and
while `torch.profiler` runs each span also opens a `record_function` of its
name. On the CPU the device duration is the host duration.
`utils/trace_summary.py` sums the device time of a Chrome trace by kernel.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import itertools
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as autograd_profiler

from fairdiff_torch.utils.tree import tree_leaves

CAPACITY = 65_536  # spans kept
MAX_EVENTS = 8_192  # CUDA events in the pool: 4096 spans awaiting their device durations
RESOLVE_EVERY = 64  # spans awaiting their device durations between two readings


class Span:
    """One span: a `with` block the recorder keeps once it has left it.
    `device_ns` is its device-stream duration (None until both of its
    events have completed, or where it recorded none)."""

    __slots__ = ("recorder", "name", "key", "id", "parent", "root", "t0_ns", "t1_ns", "device_ns", "_events",
                 "_rf")

    def __init__(self, recorder: SpanRecorder, name: str, key: Optional[int] = None):
        self.recorder, self.name, self.key = recorder, name, key
        self.device_ns: Optional[int] = None
        self._events = self._rf = None

    def __enter__(self) -> Span:
        rec = self.recorder
        stack = rec._stack()
        self.id = next(rec._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        if autograd_profiler._is_profiler_enabled:
            self._rf = autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        self._events = rec._start_event()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.time_ns()
        rec = self.recorder
        if self._events is not None:
            self._events[1].record(rec._stream())
        else:
            self.device_ns = None if torch.cuda.is_initialized() else self.t1_ns - self.t0_ns
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        rec._done(self)
        return False


class SpanRecorder:
    """Spans in a buffer of the last CAPACITY, and their timing events from
    a pool of at most MAX_EVENTS. A span that finds the pool empty records
    no event (its device duration stays None): the memory stays flat however
    long the program runs. The event pairs are read in batches: when a root
    span ends, each time RESOLVE_EVERY more wait, when the pool runs dry,
    and when the spans are read."""

    def __init__(self):
        self._spans: collections.deque[Span] = collections.deque(maxlen=CAPACITY)
        self._pending: collections.deque[Span] = collections.deque()  # spans whose events are unread
        self._free: list = []
        self._made = 0
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, key: Optional[int] = None) -> Span:
        return Span(self, name, key)

    def spans(self) -> list[Span]:
        """The recorded spans, oldest end first, each event pair whose
        events have completed read into its device duration."""
        self._resolve()
        return list(self._spans)

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _start_event(self):
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        if len(self._free) < 2 and self._made + 2 > MAX_EVENTS:
            self._resolve()
        with self._lock:
            if len(self._free) < 2:
                if self._made + 2 > MAX_EVENTS:
                    return None
                self._free += [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                self._made += 2
            events = (self._free.pop(), self._free.pop())
        events[0].record(self._stream())
        return events

    def _stream(self) -> torch.cuda.Stream:
        """The current CUDA stream, found by its raw handle: a new
        `torch.cuda.current_stream()` object costs several us."""
        raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        stream = self._streams.get(raw)
        if stream is None:
            if len(self._streams) >= 64:
                self._streams.clear()
            stream = self._streams[raw] = torch.cuda.current_stream()
        return stream

    def _done(self, span: Span) -> None:
        self._spans.append(span)
        if span._events is not None:
            self._pending.append(span)
            if span.parent is None or len(self._pending) % RESOLVE_EVERY == 0:
                self._resolve()

    def _resolve(self) -> None:
        """Read the event pairs that have completed, oldest first; stop at
        the first that has not (a stream runs its events in order)."""
        with self._lock:
            while self._pending:
                span = self._pending[0]
                start, end = span._events
                if not (end.query() and start.query()):
                    break
                span.device_ns = round(start.elapsed_time(end) * 1e6)
                span._events = None
                self._free += (start, end)
                self._pending.popleft()


RECORDER = SpanRecorder()


def span(name: str, key: Optional[int] = None) -> Span:
    """A span of the program's recorder over a `with` block; `key` names
    what a root span serves (the optimizer step)."""
    return Span(RECORDER, name, key)


def recorded_spans() -> list[Span]:
    """The program's recorded spans with their device durations."""
    return RECORDER.spans()


@contextlib.contextmanager
def trace_to(log_dir: str | Path, device: torch.device | str = "cuda"):
    """`torch.profiler` over the block, CPU and CUDA activity (the CPU alone
    when `device` is the CPU), written on exit as one Chrome trace
    `<log_dir>/<pid>.<ns>.trace.json.gz`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    path = log_dir / f"{os.getpid()}.{time.time_ns()}.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path, "rb") as src, gzip.open(path.with_suffix(".json.gz"), "wb") as dst:
        shutil.copyfileobj(src, dst)
    path.unlink()


class PhaseTimers:
    """Wall seconds per named phase of the last step, the device synchronised
    at each exit so a phase's time includes its device work; each phase is
    also a span of the recorder."""

    def __init__(self, device: torch.device):
        self.device = device
        self.last: dict[str, float] = {}

    def __call__(self, name: str) -> _Phase:
        return _Phase(self, name)


class _Phase:
    __slots__ = ("timers", "name", "span", "t0")

    def __init__(self, timers: PhaseTimers, name: str):
        self.timers, self.name, self.span = timers, name, span(name)

    def __enter__(self) -> _Phase:
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        timers = self.timers
        if timers.device.type == "cuda":
            torch.cuda.synchronize(timers.device)
        timers.last[self.name] = time.perf_counter() - self.t0
        return self.span.__exit__(*exc)


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if isinstance(tree, dict):
        return [leaf for leaf in tree_leaves(tree) for leaf in _leaves(leaf)]
    return [] if tree is None else [tree]


def tree_fingerprint(tree) -> dict[str, float]:
    """A cheap sanity fingerprint of a nested dict or list of tensors (the
    reference's `model_sanity_print`): the first element of the first leaf
    (dict keys in sorted order, as JAX flattens them) and the L2 norm of all
    leaves together, in fp32."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(tree)]
    if not leaves:
        return {"first": 0.0, "norm": 0.0}
    total = torch.sqrt(sum((leaf.detach().float() ** 2).sum() for leaf in leaves))
    return {"first": float(leaves[0].reshape(-1)[0]), "norm": float(total)}
