"""Share (%) of the traced step in which no operation ran on the device (1 -
the union of the profiler's device intervals over the step). The profiler
slows the host's side of a step, so this reads above an untraced step's
idle share (PERF.md). Moves train_s_per_step."""

from benchmark.metrics._device_idle import idle_share


def read(run):
    return idle_share(run, "train")
