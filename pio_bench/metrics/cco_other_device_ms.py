"""``cco_other_device_ms``: device milliseconds a train in everything but
the count product, K2 and K3 (densify, marginals, masks, copies, sets),
summed over the trace's activities."""


def read(ctx):
    if ctx.trace is None or ctx.steps == 0:
        return None
    return 1e3 * ctx.trace.class_s("other") / ctx.steps
