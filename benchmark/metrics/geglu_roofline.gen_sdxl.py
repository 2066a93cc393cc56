"""GEGLU's share (%) of its roofline in the SDXL cell: the bound times of the
UNet's feed-forward GEGLU at d = 640 and 1280 over the profiler's time of
K4. Moves gen_img_per_s."""

from benchmark.metrics._sdxl import roofline


def read(run):
    return roofline(run, "geglu")
