"""Shared by the roofline and mfu readers: the run's work, counted from
the configuration's shapes by benchmark.harness.arith.

A roofline is the sum of the bound times of the traced work's operations
over the sum of the profiler's kernel times of the kernels that compute
them (their trace buckets), in %. `mfu` is model FLOPs over time at the bf16
peak, in %: for generation the traced window's, for training the untraced
window steps' over their wall time (the profiler slows a training step). A
reader that finds nothing to read returns nothing."""

from benchmark.harness import arith
from benchmark.harness.trace import FLASH_BUCKETS, GEGLU_BUCKETS


def bounds_s(run) -> tuple[float, float]:
    """(flash, geglu) bound seconds of the traced work."""
    u = run.sd_config.unet
    fa = ge = 0.0
    for w in run.traced_work:
        if run.kind == "train":
            rows = 2 * run.traffic["lanes"] * w["n_steps"]
            for grad, times in ((False, 2), (True, 1)):  # phases 1 and 3 forward; phase 4b forward + backward
                f, g = arith.unet_bounds_s(u, rows, grad)
                fa, ge = fa + times * f, ge + times * g
        else:
            f, g = arith.unet_bounds_s(u, 2 * w["images"] * w["n_steps"], False)
            fa, ge = fa + f, ge + g
    return fa, ge


def roofline(run, kind: str, which: str):
    tr = run.trace
    if run.kind != kind or tr is None:
        return None
    kernel_s = tr.bucket_s(FLASH_BUCKETS if which == "flash" else GEGLU_BUCKETS)
    if kernel_s <= 0:
        return None
    fa, ge = bounds_s(run)
    return 100.0 * (fa if which == "flash" else ge) / kernel_s


def mfu(run, kind: str):
    if run.kind != kind or run.trace is None:
        return None
    f = run.unit_flops
    if kind == "train":
        if not run.work:
            return None
        flops = sum(arith.train_step_flops(f, run.traffic["lanes"], w["n_steps"]) for w in run.work)
        return 100.0 * flops / (sum(w["wall_s"] for w in run.work) * arith.PEAK_BF16_FLOPS)
    if not run.traced_work:
        return None
    flops = sum(arith.gen_batch_flops(f, w["images"], w["n_steps"]) for w in run.traced_work)
    return 100.0 * flops / (run.trace.window_s * arith.PEAK_BF16_FLOPS)
