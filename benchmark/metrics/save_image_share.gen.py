"""Share (%) of the window's wall time in the program's "save_image" spans
(each image's conversion, JPEG encode and file write). Moves
gen_img_per_s."""

from benchmark.metrics import _program


def read(run):
    if run.kind != "gen" or run.window_s <= 0:
        return None
    spans = _program.spans_in(*run.window_ns, ("save_image",))
    return 100.0 * _program.host_s(spans) / run.window_s if spans else None
