"""Shared by the PhaseTimers readers: the seconds of some of the program's
phases an untraced window step (the profiler slows a step, and a traced
run keeps its traced step out of `work`), each step's scaled to the
traffic's middle denoising count, since a seed's steps draw 19-23."""


def per_step(run, phases: tuple[str, ...]):
    if run.kind != "train" or not run.work:
        return None
    low, high = run.traffic["denoising_steps"]
    mid = (low + high) / 2
    return sum(s["phases"][p] * mid / s["n_steps"] for s in run.work for p in phases) / len(run.work)
