"""Share of the traced study's host span in which no operation ran on
the device: 1 - (union of device events) / (study span)."""


def read(ctx):
    window = ctx.trace['window_s']
    if window <= 0:
        return None
    return 1. - ctx.trace['busy_s'] / window
