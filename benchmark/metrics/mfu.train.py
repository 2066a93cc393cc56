"""Model FLOPs of the untraced window steps of a traced run (UNet, text
encoder, VAE and the zoo, from the reference's modules at the
configuration's shapes; no recompute) over their wall time at 989 TFLOP/s,
in %: the whole step's share of the peak. Moves train_s_per_step."""

from benchmark.metrics._rooflines import mfu


def read(run):
    return mfu(run, "train")
