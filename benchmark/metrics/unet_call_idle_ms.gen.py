"""Idle device time (ms) inside the program's "unet_call" spans (one CFG
UNet call a denoising step of `generate`) in the traced window, over their
count. Moves gen_img_per_s."""

from benchmark.metrics import _program


def read(run):
    if run.kind != "gen" or run.trace is None:
        return None
    spans = _program.spans_in(*_program.traced(run), ("unet_call",))
    return 1e3 * _program.idle_s(run.trace.gaps, spans) / len(spans) if spans else None
