"""``device_idle_pct.train``: the share of the traced window in which no
device activity runs: the union of every kernel, copy and set interval,
not a sum of their times, against the window's length."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
