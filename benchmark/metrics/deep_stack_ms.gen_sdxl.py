"""Device-stream ms of the 10-layer 1280-channel transformer stacks (the
program's "transformer_stack" spans of the deepest key under "unet_call")
in the traced window, per UNet call. Moves gen_img_per_s."""

from benchmark.metrics._sdxl import deep_stack_ms


def read(run):
    return deep_stack_ms(run)
