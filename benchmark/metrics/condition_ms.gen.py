"""Device-stream ms of the conditioning of a `generate` call: its
"encode_prompt" (the text encoding, the text-encoder LoRA's merge included)
and "merge_lora" (the UNet LoRA's merge) spans in the traced window, over
the window's "generate" spans. Moves gen_img_per_s."""

from benchmark.metrics import _program


def read(run):
    if run.kind != "gen" or run.trace is None:
        return None
    window = _program.traced(run)
    calls = _program.spans_in(*window, ("generate",))
    d = _program.device_s(_program.spans_in(*window, ("encode_prompt", "merge_lora"), ("generate",)))
    return 1e3 * sum(d) / len(calls) if calls and d else None
