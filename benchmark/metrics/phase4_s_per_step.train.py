"""Seconds of phase 4 (`PhaseTimers` "phase4_backward": the loss VJP and
the pair VJPs, synchronised) an untraced window step, scaled to a step of
the traffic's middle denoising count (21 for 19-23). Moves
train_s_per_step."""

from benchmark.metrics._phases import per_step


def read(run):
    return per_step(run, ("phase4_backward",))
