"""``launches_per_batch``: CUDA kernels a batch, counted in the trace over
the traced batches, the readback's included."""


def read(ctx):
    n = sum(1 for k in ctx.trace.device if k.cat == "kernel")
    return n / ctx.n_traced if n else None
