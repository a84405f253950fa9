"""``count_product_roofline_pct``: the count product's least time at the
card's published peaks, over its device time in the trace.  Each call of
``aten::_int_mm`` is bounded by its own shapes (``counts.
count_product_bound_s``); the sum is scaled down to the dense work the
window's trains need where the calls' padded shapes hold more."""

from pio_bench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.count_product_launches()
    if not calls or any(shapes is None or len(shapes) < 2 for shapes, _ in calls):
        return None
    bound = spent = ops = 0.0
    for shapes, seconds in calls:
        (m, k), (_, n) = shapes[0], shapes[1]
        bound += counts.count_product_bound_s(m, k, n)
        ops += 2.0 * m * k * n
        spent += seconds
    need = ctx.steps * counts.dense_ops_per_train(ctx.cfg)
    return 100.0 * bound * min(1.0, need / ops) / spent if spent > 0 else None
