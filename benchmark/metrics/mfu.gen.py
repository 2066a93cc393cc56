"""The traced window's model FLOPs (UNet, text encoder, VAE and the zoo, from
the reference's modules at the configuration's shapes; no recompute) over
its time at 989 TFLOP/s, in %: the whole step's share of the peak. Moves
gen_img_per_s."""

from benchmark.metrics._rooflines import mfu


def read(run):
    return mfu(run, "gen")
