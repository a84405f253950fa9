"""``k2_roofline_pct``: K2's bytes of the window's trains (the count
matrix of every event type read once and its scores written once,
``counts.k2_bytes_per_train``) at HBM's published rate, over the device
time of every ``llr_masked_kernel`` in the trace."""

from pio_bench import counts


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.class_s("k2")
    if spent <= 0:
        return None
    need = ctx.steps * counts.k2_bytes_per_train(ctx.cfg) / counts.HBM_BYTES_S
    return 100.0 * need / spent
