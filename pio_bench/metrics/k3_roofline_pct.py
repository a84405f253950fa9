"""``k3_roofline_pct``: K3's bytes of the window's trains (every score
read once, every row's top k written once, ``counts.k3_bytes_per_train``)
at HBM's published rate, over the device time of every
``tile_topk_kernel`` in the trace."""

from pio_bench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.class_s("k3")
    if spent <= 0:
        return None
    need = ctx.steps * counts.k3_bytes_per_train(ctx.cfg) / counts.HBM_BYTES_S
    return 100.0 * need / spent
