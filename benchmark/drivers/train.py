"""The training cells: `DebiasTrainer.train_step` as tools/train_debias.py
builds it (remat at SD-1.5 width, the configuration's flash backward,
AdamW and EMA), fed by the "train" traffic generator.

Set-up builds the trainer, draws the weights and adapters from the seed,
and runs step 0 through the window's own call: it warms every shape, and
its loss, its gradient as AdamW holds it (exp_avg / (1 - beta1)) and the
change it made to the adapters and their EMA are the readings the
reference is held to. The window then runs whole triples of steps until
`seconds` have passed; train_s_per_step is its wall time over its steps. A
traced run runs one step and then one under the profiler, and stops. After
the window the program is freed and the reference (fp32, TF32 off) runs
step 0 on the same inputs.

The step's discrete decisions flip under rounding (benchmark.reference.
trainer), so the reference takes the program's: the benchmark wraps the
classifier and the face database it hands the program's stack and records,
during step 0 only, the phase-1 and phase-3 gender probabilities (from
which `decisions` gives the program's targets, predictions and
confidences) and the rows each phase-4 search returned, and it keeps each
lane's phase-4 loss from the trainer's loss function. The stages this skips
are printed beside the compared numbers: the probabilities against the
reference's own ("probs", the widest gap), and each searched row against
the reference's best for the same lane ("search", the widest shortfall of
its score). Each lane's loss is held to the reference's ("lane_loss"): the
step's loss is a mean over lanes, and a lane left out or counted twice
moves it less than rounding does.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time

import numpy as np
import torch

from benchmark.harness import compare, models
from benchmark.harness import record as record_lib
from benchmark.harness.record import RunRecord
from benchmark.harness.trace import DeviceTrace, RecordingTimers, TraceResult
from benchmark.harness import traffic as traffic_lib

BETA1 = 0.9


class Recorder:
    """Wraps a callable of the program and keeps (when `on`) `keep` of what
    each call returned, detached."""

    def __init__(self, fn, keep=lambda out: out):
        self.fn, self.keep, self.on, self.calls = fn, keep, False, []

    def __call__(self, *args):
        out = self.fn(*args)
        if self.on:
            self.calls.append(self.keep(out).detach())
        return out


class RecordingDB:
    """The program's face database; keeps (when `on`) the rows each search
    returned."""

    def __init__(self, db):
        self.db, self.on, self.rows = db, False, []
        self.feats, self.genders, self.extra = db.feats, db.genders, db.extra

    def semantic_search(self, queries):
        idx, feats = self.db.semantic_search(queries)
        if self.on:
            self.rows.append(idx.detach().cpu())
        return idx, feats


def gender_probs(logits: torch.Tensor) -> np.ndarray:
    """[N, 2] probabilities of the CelebA head's gender logits (attribute 20)."""
    return torch.softmax(logits.float().reshape(logits.shape[0], -1, 2)[:, 20, :], dim=-1).cpu().numpy()


def debias_config(config: dict, mix: dict, seed: int):
    from fairdiff_torch.training.debias import DebiasConfig

    d = dict(config["debias"])
    for k in ("attributes", "factor1", "factor2", "uncertainty_thresholds"):
        d[k] = tuple(d[k])
    return DebiasConfig(**d, train_images_per_prompt=mix["lanes"], train_micro_batch=mix["micro_batch"],
                        steps_low=mix["denoising_steps"][0], steps_high=mix["denoising_steps"][1], seed=seed,
                        eval_interval=0)


def step_readings(leaves, opt, ema_leaves, before) -> dict[str, np.ndarray]:
    """Per leaf: the gradient AdamW received (from its first moment after
    one step), the change of the leaf, the change of its EMA."""
    grads = [opt.state[p]["exp_avg"] / (1 - BETA1) if p in opt.state else torch.zeros_like(p) for p in leaves]
    return {
        "grad": compare.leaf_norms(grads),
        "change": compare.leaf_norms([p.detach() - b for p, b in zip(leaves, before)]),
        "ema": compare.leaf_norms([e.detach() - b for e, b in zip(ema_leaves, before)]),
    }


def run_reference(ctx, first: dict, fp8: bool = False, follow: dict | None = None) -> dict:
    """The reference's step 0 on the run's inputs, taking the discrete
    decisions of another run `follow` ({"probs1", "probs3", "search"}: its
    probabilities decide its targets, predictions and confidences, which the
    step takes; nothing continuous of it enters the step) where given ->
    {"loss", "probs1", "probs3", "search", readings..., and with `follow` the
    "search_gap": the widest shortfall of a followed row's score below the
    best row's, on this run's face features}."""
    from benchmark.reference import lowp
    from benchmark.reference.trainer import StepConfig, decisions, train_step
    from benchmark.reference.tree import tree_leaves, tree_map

    config, mix, dev = ctx.cell["config"], ctx.cell["traffic"], ctx.device
    d = config["debias"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    w = models.Weights(config, ctx.seed, dev, ctx.dtype)
    sd = models.reference_sd(config, w, dev)
    stack = models.reference_stack(config, w, dev)
    adapters = tree_map(lambda x: x.detach().clone().requires_grad_(), w.adapters())
    leaves = tree_leaves(adapters)
    before = [p.detach().clone() for p in leaves]
    opt = torch.optim.AdamW(leaves, lr=d["learning_rate"], betas=(BETA1, 0.999), eps=1e-8,
                            weight_decay=d["weight_decay"])
    ema = tree_map(lambda p: p.detach().clone(), adapters)
    cfg = StepConfig(lanes=mix["lanes"], micro_batch=mix["micro_batch"], target_ratio=d["target_ratio"],
                     uncertainty_threshold=d["uncertainty_thresholds"][0], guidance_scale=d["guidance_scale"],
                     weight_loss_img=d["weight_loss_img"], weight_loss_face=d["weight_loss_face"],
                     factor1=d["factor1"][0], factor2=d["factor2"][0],
                     face_confidence_level=d["face_confidence_level"], ema_decay=d["ema_decay"])
    taken = None
    if follow is not None:
        taken = {"targets": None, "preds": None, "confident": None, "search": follow["search"]}
        if follow["probs1"] is not None:
            taken.update(decisions(follow["probs1"], follow["probs3"], cfg))
    with lowp.fp8() if fp8 else contextlib.nullcontext():
        out = train_step(sd, stack, cfg, adapters, opt, ema, 0, first["cond_ids"], first["uncond_ids"],
                         first["noises"], first["n_steps"], taken)
    res = {k: out[k] for k in ("loss", "lanes", "targets", "own_targets", "probs1", "probs3", "search")}
    if follow is not None and follow["search"] is not None:
        scores = out["feats"] @ stack.face_db.feats.T
        rows = torch.as_tensor(follow["search"], device=scores.device).long()
        res["search_gap"] = float((scores.amax(-1) - scores.gather(1, rows[:, None])[:, 0]).max())
    return {**res, **step_readings(leaves, opt, tree_leaves(ema), before)}



def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers read: the step's loss (relative), and by the worst leaf
    the gradient AdamW got, the adapters' change and the EMA's change
    (leaves the reference's gradient leaves unmoved left out of the two
    changes); the widest gap of a phase-1 or phase-3 probability; the
    follower's "search_gap"; the widest lane's loss gap over the mean lane
    loss. The cell's limits file names those compared (PERF.md gives the
    readings of each)."""
    keep = compare.moving_leaves(ref["grad"])
    probs = max(float(np.abs(prog[k] - ref[k]).max()) if prog[k] is not None else np.inf for k in ("probs1", "probs3"))
    return {
        "loss": abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
        "grad": compare.worst_leaf_gap(prog["grad"], ref["grad"]),
        "change": compare.worst_leaf_gap(prog["change"], ref["change"], keep),
        "ema": compare.worst_leaf_gap(prog["ema"], ref["ema"], keep),
        "probs": probs,
        "search": max((d["search_gap"] for d in (prog, ref) if "search_gap" in d), default=np.inf),
        "lane_loss": (float(np.abs(prog["lanes"] - ref["lanes"]).max() / np.abs(ref["lanes"]).mean())
                      if prog["lanes"] is not None and prog["lanes"].shape == ref["lanes"].shape else np.inf),
    }


def first_step(ctx):
    """The cell's training feed (`traffic.train_steps`), step 0 first."""
    s = models.ref_sd_config(ctx.cell["config"]).unet.sample_size
    return traffic_lib.train_steps(ctx.cell["traffic"], ctx.seed, (s, s, 4), ctx.device,
                                   *models.text_shape(ctx.cell["config"]))


def run(ctx) -> dict:
    from fairdiff_torch.training.debias import DebiasTrainer
    from fairdiff_torch.utils.tree import tree_leaves

    config, mix, dev, spans = ctx.cell["config"], ctx.cell["traffic"], ctx.device, ctx.spans
    with spans.span("build"):
        w = models.Weights(config, ctx.seed, dev, ctx.dtype)
        sd = models.program_sd(config, w, dev)
        guidance = models.program_stack(config, w, dev, ctx.dtype)
        guidance.classify_fn = classify = Recorder(guidance.classify_fn)
        guidance.face_db = db = RecordingDB(guidance.face_db)
        trainer = DebiasTrainer(sd, guidance, debias_config(config, mix, ctx.seed))
        trainer.timers = RecordingTimers(trainer.timers, spans)
        trainer._images_loss = lane_loss = Recorder(trainer._images_loss, lambda out: out[1]["loss"])
        state = trainer.init_state(adapters=w.adapters())
        del w
    feed = first_step(ctx)
    first = next(feed)
    leaves = tree_leaves(state.adapters)
    before = [p.detach().clone() for p in leaves]
    classify.on = db.on = lane_loss.on = True
    with spans.span("step0"):
        state, logs = trainer.train_step(state, (first["cond_ids"], first["uncond_ids"]), noises=first["noises"],
                                         n_steps=first["n_steps"])
    classify.on = db.on = lane_loss.on = False
    # classifier calls of step 0: phase 1, phase 3, then phase 4's chunks
    prog = {"loss": logs["train_loss"], "probs1": gender_probs(classify.calls[0]),
            "probs3": gender_probs(classify.calls[1]), "search": torch.cat(db.rows).numpy(),
            "lanes": torch.cat(lane_loss.calls).float().cpu().numpy(),
            **step_readings(leaves, state.opt, tree_leaves(state.ema), before)}
    del classify.calls[:], db.rows[:], lane_loss.calls[:]
    if any(prog[k].shape[0] != mix["lanes"] for k in ("search", "probs1", "lanes")):
        print(f"[train] step 0 searched {prog['search'].shape}, classified {prog['probs1'].shape}, lost "
              f"{prog['lanes'].shape} lanes of {mix['lanes']}", file=sys.stderr)
        prog["search"], prog["probs1"], prog["lanes"] = None, None, None
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    print(f"[train] set-up {setup_s:.1f} s: models {spans.total_s('build'):.1f} s, step 0 {spans.total_s('step0'):.1f} s",
          file=sys.stderr)

    # Untraced, the window runs whole triples of steps (each triple's
    # denoising steps sum to 3 x the middle count, so every window does the
    # same work) until `seconds` have passed. Traced, it runs one step, then
    # one step under the profiler, and ends there: the profiler slows a step,
    # so the PhaseTimers metrics and mfu read the untraced step, and the
    # trace's metrics the traced one.
    steps, tracer, traced_ns = [], None, None
    t0_ns, t0 = time.time_ns(), time.perf_counter()
    while (len(steps) < 2) if ctx.trace else (time.perf_counter() - t0 < ctx.seconds or len(steps) % 3):
        item = next(feed)
        profiled = ctx.trace and len(steps) == 1
        with DeviceTrace(profiled) as tr:
            s0_ns, s0 = time.time_ns(), time.perf_counter()
            with spans.span("train_step"):
                state, logs = trainer.train_step(state, (item["cond_ids"], item["uncond_ids"]),
                                                 noises=item["noises"], n_steps=item["n_steps"])
            ctx.sync()
            s1_ns, wall_s = time.time_ns(), time.perf_counter() - s0
        if profiled:
            tracer, traced_ns = tr, (s0_ns, s1_ns)
        steps.append({"n_steps": item["n_steps"], "phases": dict(trainer.timers.last), "wall_s": wall_s,
                      "traced": profiled, "finite": bool(logs["grads_finite"]) and np.isfinite(logs["train_loss"])})
    ctx.sync()
    window_s, t1_ns = time.perf_counter() - t0, time.time_ns()
    peak = ctx.peak_bytes()
    del trainer, state, sd, guidance, leaves, before, logs
    gc.collect()
    ctx.empty_cache()
    prepared = {}
    if ctx.trace:
        plain = [s_ for s_ in steps if not s_["traced"]]
        slowdown = (steps[-1]["wall_s"] / steps[-1]["n_steps"]) / (plain[0]["wall_s"] / plain[0]["n_steps"])
        print(f"[train] traced step {steps[-1]['wall_s']:.3f} s for {steps[-1]['n_steps']} denoising steps, "
              f"untraced {plain[0]['wall_s']:.3f} s for {plain[0]['n_steps']}: the profiler slows a denoising step "
              f"{slowdown:.3f}x", file=sys.stderr)

        def prepare():
            try:
                prepared["trace"] = TraceResult(tracer.read(), *traced_ns, spans.items)
                record_lib.prepare(config)
            except BaseException as e:  # re-raised in the main thread
                prepared["error"] = e

        # host work only, beside the reference's device work
        preparing = threading.Thread(target=prepare, name="trace-reader")
        preparing.start()

    t_ref = time.perf_counter()
    print(f"[train] window closed at {t_ref - ctx.t_start:.1f} s", file=sys.stderr)
    ref = run_reference(ctx, first, follow=prog)
    agree = float(np.mean(ref["targets"] == ref["own_targets"]))
    search = float(np.mean(prog["search"] == ref["search"]))
    print(f"[train] reference step 0 in {time.perf_counter() - t_ref:.1f} s; {first['n_steps']} denoising steps, "
          f"loss {prog['loss']:.6g} vs {ref['loss']:.6g}; the reference's own targets agree on {agree:.3f} of the "
          f"lanes, its own search rows on {search:.3f}", file=sys.stderr)
    found = numbers(prog, ref)
    keep = compare.moving_leaves(ref["grad"])
    print(f"[train] {int(keep.sum())} of {keep.size} leaves move in the reference; not compared (no reading of "
          "the control or a fault above them): "
          + ", ".join(f"{k} {v!r}" for k, v in found.items() if k not in ctx.cell["limits"]), file=sys.stderr)
    ok, checks = compare.judge(found, ctx.cell["limits"])
    if ctx.trace:
        preparing.join()
        if "error" in prepared:
            raise prepared["error"]
        print(f"[train] trace reduced at {time.perf_counter() - ctx.t_start:.1f} s", file=sys.stderr)
    record = RunRecord("train", config, mix, window_s, [s_ for s_ in steps if not s_["traced"]], spans,
                       (t0_ns, t1_ns), peak, prepared.get("trace"), [s_ for s_ in steps if s_["traced"]])
    return {
        "correct": ok and all(s["finite"] for s in steps), "checks": checks,
        "attempted": len(steps), "failed": sum(not s["finite"] for s in steps),
        "end_to_end": {"train_s_per_step": window_s / len(steps), "setup_s": setup_s},
        "record": record,
    }
