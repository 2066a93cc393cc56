"""Flash attention's share (%) of its roofline: the bound times of the
UNet's self-attention over >= 512 keys (forward, and in training its
backward) over the profiler's time of the flash kernels (K1, K1-lse, K2,
K3, K6). Moves gen_img_per_s."""

from benchmark.metrics._rooflines import roofline


def read(run):
    return roofline(run, "gen", "flash")
