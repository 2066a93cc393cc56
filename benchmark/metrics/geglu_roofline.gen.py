"""GEGLU's share (%) of its roofline: the bound times of the UNet's
feed-forward GEGLU (forward, and in training its input gradient) over the
profiler's time of K4 and K5. Moves gen_img_per_s."""

from benchmark.metrics._rooflines import roofline


def read(run):
    return roofline(run, "gen", "geglu")
