"""Share (%) of the host time of the program's "pair_vjp" spans in the
traced step in which the device ran nothing (the trace's idle gaps
clipped to the spans). Moves train_s_per_step."""

from benchmark.metrics import _program


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    spans = _program.spans_in(*_program.traced(run), ("pair_vjp",))
    host = _program.host_s(spans)
    return 100.0 * _program.idle_s(run.trace.gaps, spans) / host if host > 0 else None
