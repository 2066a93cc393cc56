"""The process's device memory peak through set-up and the window
(`torch.cuda.max_memory_allocated`), GiB. Moves train_s_per_step."""


def read(run):
    if run.kind != "train" or not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
