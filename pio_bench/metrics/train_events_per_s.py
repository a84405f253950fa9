"""``train_events_per_s``: every event of every train the window
completed, over the window's seconds (its start to the end of its last
train), by the host's clock."""

from pio_bench import counts


def read(ctx):
    if ctx.steps == 0 or ctx.window_s <= 0:
        return None
    return ctx.steps * counts.events_per_train(ctx.cfg) / ctx.window_s
