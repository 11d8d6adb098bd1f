"""``idle_share``: the share of the traced window (first to last device
operation) in which no kernel, copy or fill ran on the card."""


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
