"""device.idle_pct: the share of the traced window in which nothing ran
on the device (``torch.profiler``: kernels, copies and sets)."""


def read(run: dict):
    trace = run["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
