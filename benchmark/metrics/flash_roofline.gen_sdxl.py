"""Flash attention's share (%) of its roofline in the SDXL cell: the bound
times of the UNet's self-attention at head dim 64 (4096 tokens, 10 heads;
1024 tokens, 20 heads) over the profiler's time of the flash kernels (K1).
Moves gen_img_per_s."""

from benchmark.metrics._sdxl import roofline


def read(run):
    return roofline(run, "flash")
