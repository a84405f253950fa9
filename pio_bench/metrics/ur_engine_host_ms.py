"""``ur_engine_host_ms``: milliseconds a train inside the program's
``ur.train`` span that its ``cco.train`` span does not cover: the UR
engine's own work around the CCO driver (the tables' conversion, the seen
lookups, the popularity backfill), host time with any wait on the card in
it, from the program's spans inside the traced window (``spans.py``)."""

from pio_bench import spans


def read(ctx):
    if ctx.trace is None or ctx.steps == 0:
        return None
    got = spans.window_spans(ctx.trace)
    if not any(name == "ur.train" for _, _, name in got):
        return None
    return spans.self_ns(got, "ur.train", "cco.train") / 1e6 / ctx.steps
