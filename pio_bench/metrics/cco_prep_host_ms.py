"""``cco_prep_host_ms``: milliseconds a train that the union of the
program's ``cco.check_ids``, ``cco.flatten`` and ``cco.stage`` spans
covers: the CCO driver's host time before its tiles (the id checks, the
blocked layout back to pairs, the int64 copies, the host-to-device copy,
the densify and marginal launches and the sort's readback), waits on the
card included, from the program's spans inside the traced window
(``spans.py``)."""

from pio_bench import spans

PREP = ("cco.check_ids", "cco.flatten", "cco.stage")


def read(ctx):
    if ctx.trace is None or ctx.steps == 0:
        return None
    got = spans.window_spans(ctx.trace)
    if not any(name in PREP for _, _, name in got):
        return None
    return spans.covered_ns(got, PREP) / 1e6 / ctx.steps
