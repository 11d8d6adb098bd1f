"""``glue_ms``: device ms a batch of the pipeline's glue, every kernel that a
batch's call (the ``bench.batch`` span) launched outside the port's named
kernel ops (``disco_torch::*``) and outside the masks (the ``bench.masks``
span): the step-2 stacks, gathers, copies, the filtering, the ISTFT's
products and the solves' padding."""


def read(ctx):
    glue = [k.dur for k in ctx.trace.device
            if k.cat == "kernel" and "bench.batch" in k.spans and k.op is None
            and "bench.masks" not in k.spans]
    if not glue:
        return None
    return sum(glue) / 1e3 / ctx.n_traced
