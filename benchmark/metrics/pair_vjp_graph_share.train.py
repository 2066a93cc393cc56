"""Share (%) of the program's "pair_vjp" spans in the untraced window step
that replay a CUDA graph (have a "graph_replay" child): 0 where the pair
VJPs run eagerly, None where the program records no "pair_vjp" span. Moves
train_s_per_step."""

from benchmark.metrics import _program


def read(run):
    if run.kind != "train":
        return None
    step = _program.untraced_step(run)
    pairs = _program.spans_in(*step, ("pair_vjp",))
    if not pairs:
        return None
    replayed = {s.parent for s in _program.spans_in(*step, ("graph_replay",), ("pair_vjp",))}
    return 100.0 * sum(s.id in replayed for s in pairs) / len(pairs)
