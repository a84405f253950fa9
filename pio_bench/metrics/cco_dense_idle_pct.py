"""``cco_dense_idle_pct``: the share of the ``cco.dense`` ranges' device
time (``dense_ranges``) in which no kernel, copy or set runs: the card
waiting on the host inside the dense route."""

from pio_bench import dense_ranges


def read(ctx):
    got = dense_ranges.window_extents(ctx)
    if got is None:
        return None
    total = sum(e - s for s, e in got)
    return 100.0 * (1.0 - dense_ranges.busy_ns(ctx.trace, got) / total)
