"""``cco_dense_roofline_pct``: the dense route's least time at the card's
published peaks (``dense_counts.bound_s_per_train``: for each event type
the larger of its count product's operations at the int8 peak and of the
bytes its densified chunks and count matrix must move at HBM's rate), over
the device time of the program's ``cco.dense`` ranges in the trace
(``dense_ranges``)."""

from pio_bench import dense_counts, dense_ranges


def read(ctx):
    got = dense_ranges.window_extents(ctx)
    if got is None:
        return None
    spent = sum(e - s for s, e in got) / 1e9
    return 100.0 * ctx.steps * dense_counts.bound_s_per_train(ctx.cfg) / spent
