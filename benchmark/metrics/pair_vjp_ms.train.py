"""Mean device-stream duration (ms) of the program's "pair_vjp" spans (one
single-step UNet VJP of a lane chunk at a denoising step, in phase 4b)
in the untraced window step. Moves train_s_per_step."""

from benchmark.metrics import _program


def read(run):
    if run.kind != "train":
        return None
    d = _program.device_s(_program.spans_in(*_program.untraced_step(run), ("pair_vjp",)))
    return 1e3 * sum(d) / len(d) if d else None
