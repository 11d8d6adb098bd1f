"""``dispatch_ms``: host ms from a batch's call to its return, the median over
the measured window's batches (host clock; the launches are asynchronous, so
this is the host's cost of enqueuing a batch, waits inside it included)."""

import statistics


def read(ctx):
    d = ctx.window["dispatch_s"]
    return 1e3 * statistics.median(d) if d else None
