"""Device-stream seconds of the program's "analyze" spans of phases 1 and 3
(the guidance analysis of the sampled images) in the untraced window step;
not scaled, since the analysis does not depend on the denoising steps.
Moves train_s_per_step."""

from benchmark.metrics import _program

PHASES = ("phase1_sample_analyze", "phase3_frozen_sample")


def read(run):
    if run.kind != "train":
        return None
    d = _program.device_s(_program.spans_in(*_program.untraced_step(run), ("analyze",), PHASES))
    return sum(d) if d else None
