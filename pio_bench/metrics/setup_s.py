"""``setup_s``: seconds from the run's start to the end of the warm-up
step: imports, the events from the seed, the program's set-up, kernel
builds and loads on a checkout's first run, and one whole step."""


def read(ctx):
    return ctx.setup_s
