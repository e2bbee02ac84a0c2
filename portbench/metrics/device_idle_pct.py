"""device_idle_pct: the share of the traced window, in %, in which no
device operation (kernel, copy or memset) ran, from ``torch.profiler``."""


def read(ctx):
    if not ctx["window_s"] or not ctx["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
