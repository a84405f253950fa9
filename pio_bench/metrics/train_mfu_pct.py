"""``train_mfu_pct``: the dense count products' int8 operations of the
window's trains (Σ 2·U·I_p·I_t a train, counted from the configuration),
as a share of what the card's published int8 peak does in the window's
seconds.  The card's power limit is printed beside it."""

from pio_bench import counts


def read(ctx):
    if ctx.trace is None or ctx.steps == 0:
        return None
    ops = ctx.steps * counts.dense_ops_per_train(ctx.cfg)
    return 100.0 * ops / (ctx.window_s * counts.INT8_PEAK_OPS)
