"""Share (%) of the traced window in which no operation ran on the device (1 -
the union of the profiler's device intervals over the traced window). Moves
gen_img_per_s."""

from benchmark.metrics._device_idle import idle_share


def read(run):
    return idle_share(run, "gen")
