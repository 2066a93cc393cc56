"""The SDXL cell's traced window: model FLOPs (both text encoders, the UNet
at 1024 px, the VAE decode, from the reference's modules at the
configuration's shapes) over the window's time at 989 TFLOP/s, in %: the
whole step's share of the peak. Moves gen_img_per_s."""

from benchmark.metrics._sdxl import mfu


def read(run):
    return mfu(run)
