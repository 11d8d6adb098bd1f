"""``mfu``: the whole batch's share of the card's peak.  The least time a
batch needs (the larger of its frozen operations over the float32 peak and
its frozen bytes over the HBM bandwidth, ``costs.*_batch_need``) over the
time a batch took in the measured window (the window's seconds over its
batches, host clock)."""


def read(ctx):
    win = ctx.window
    if not win["batches"]:
        return None
    flops, nbytes = ctx.need
    least = ctx.costs.bound_s(flops, nbytes)[0]
    return 100.0 * least / (win["seconds"] / win["batches"])
