"""``ur_outside_dense_ms``: milliseconds a train of the traced window
outside the device extent of the ``cco.dense`` ranges (``dense_ranges``):
the engine's host work, the id checks and the primary's staging before the
first dense run, the readback after the last, and the gaps between trains."""

from pio_bench import dense_ranges


def read(ctx):
    got = dense_ranges.window_extents(ctx)
    if got is None:
        return None
    w0, w1 = ctx.trace.window_ns
    return (w1 - w0 - sum(e - s for s, e in got)) / 1e6 / ctx.steps
