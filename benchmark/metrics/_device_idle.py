"""Shared by the device_idle_share readers: 100 (1 - busy / window), the
busy time the union of the device's event intervals in the traced window."""


def idle_share(run, kind: str):
    tr = run.trace
    if run.kind != kind or tr is None or tr.n_events == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
