"""Share (%) of the window's wall time in the benchmark's span around
`save_image` (the JPEG encode and write of each image). Moves
gen_img_per_s."""


def read(run):
    if run.kind != "gen" or run.window_s <= 0:
        return None
    return 100.0 * run.span_s("save_image") / run.window_s
