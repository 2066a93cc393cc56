"""Seconds of phases 1 and 3 (`PhaseTimers` "phase1_sample_analyze" and
"phase3_frozen_sample": the two sampling chains and their analysis) an
untraced window step, scaled to a step of the traffic's middle denoising
count (21 for 19-23). Moves train_s_per_step."""

from benchmark.metrics._phases import per_step


def read(run):
    return per_step(run, ("phase1_sample_analyze", "phase3_frozen_sample"))
